// Fused full-circuit statevector kernels (kernels 1 and 2 of the port).
//
// fidelity_kernel replaces repro/kernels/vqc_statevector.py::_fidelity_kernel
// (launched from _grid_call): evolve each circuit of the batch from |0...0>
// through the spec's op table with its own angles (theta row c, data row c)
// and write the ancilla P(0).  Materialized banks and per-worker row
// batches take it.
//
//   One warp per circuit, W warps a block (fused_geometry in
//   vqc_statevector.py), the circuit's state in the warp's slice of dynamic
//   shared memory (2 * 4 * 2^n bytes: 1 KB at n = 7).  Each gate is one
//   pass of the 32 lanes over its amplitude pairs (2 pairs a lane for a
//   one-qubit gate at n = 7) followed by __syncwarp(); no block barrier.
//   The op angles are computed 32 at a time, lane k taking op k (the same
//   cosf/sinf of the same argument as the one-thread kernel it replaces),
//   and broadcast with __shfl_sync.  P(0) is each lane's partial sum over
//   the first half of the amplitudes, then a warp reduction.
//
//   Bound on an H100: device memory moves only (P + D) * 4 bytes in and 4
//   bytes out per circuit against some 6 flops per amplitude per rotation,
//   so the float32 arithmetic bounds it.  The kernel this replaced gave
//   each circuit one thread that walked the whole state serially (2^(n-1)
//   dependent shared-memory read-modify-writes a gate) in blocks of 128
//   circuits, 33 blocks of 4 warps at C = 4,176: latency-bound on a
//   quarter of the SMs.  A warp per circuit makes the 4,176 circuits 4,176
//   warps over every SM and cuts each gate's serial chain 32-fold.
//
// state_kernel replaces ::_state_kernel: the same evolution on the same
// geometry (fused_geometry), ending in a store of the final (re, im) state
// instead of the P(0) reduction.  Lane l writes amplitudes l, l + 32, ...
// of its circuit's row, so a warp's stores are coalesced.  Bound on an
// H100: its 2 * 4 * 2^n bytes of output per circuit (bytes, where the
// fidelity kernel is arithmetic-bound).  The one-thread kernel it replaced
// needed a warp of 32 states a block and refused 10 qubits and more; this
// one runs up to 14.  It is off the training path (tests and the smoke).
//
// The device-memory route (fidelity_dmem_kernel, state_dmem_kernel) runs the
// same two functions at the widths where one circuit's state does not fit a
// block's 227 KB of shared memory (from 15 qubits: 256 KB; fused_geometry
// gives (0, 0)), which the reference's kernels accept and its serving
// system routes to MeshSpillExecutor.  The state's (re, im) float32
// amplitudes live in device memory (a workspace of the wrapper's for the
// fidelity, the output rows themselves for the state): 1 MB a circuit at
// 17 qubits.  The op table runs in passes (dmem_plan in
// vqc_statevector.py): each pass's gates act on at most k = 13 local qubits,
// so the state splits into 2^(n - k) chunks of 2^k amplitudes (64 KB), the
// local bits varying and the others fixed.  A block loads a chunk into
// shared memory, applies the pass's gates one after another with
// __syncthreads between them, and stores it back; the next pass reads what
// this one stored.  Each amplitude meets the same gates in the same order
// with the same arithmetic (rot1, rot2, dot2, op_angle) as in the warp
// kernels, so the state is theirs.  Every pass keeps the three lowest-order
// qubits local, so four local neighbours are four neighbours in device
// memory: loads and stores move float4s and cover whole 32-byte sectors, a
// gate on local bits >= 2 moves four amplitudes a shared load
// (strided_apply4), consecutive rotations of one qubit share one sweep over
// the chunk (rot1_run4), and one-qubit gates on local bits 0 and 1 run
// inside each float4 (low_run4).  Amplitudes no earlier pass had local are
// still 0 (the pass's zero mask): the first pass makes |0...0> in shared
// memory and computes only the chunk that holds it, later passes do not
// read such amplitudes and skip chunks made only of them (the state
// kernel's last pass stores their zeros), and the fidelity's last pass
// stores nothing: it writes one partial P(0) a chunk over the chunk's
// ancilla-0 half (in the chunk's first amplitude, which only its own block
// reads), and the circuit's first block sums them in chunk order.  At
// 17q-1l (42 gates) that is 3 passes and 2.2 MB of state traffic a circuit
// for P(0) (3.3 MB for the state), where the per-gate scheme this replaced
// made one block-stride pass over the state a gate, 37.5 full passes (some
// 75 MB).  A circuit is one thread-block cluster (dmem_geometry: up to 8
// blocks, fewer as the batch fills the card); its blocks take a pass's
// chunks in turn, cluster.sync() sits between passes, and device memory is
// read and written through L2 (ld.global.cg, st.global.cg), so a pass sees
// its cluster's stores.  P(0) and the state do not depend on the cluster
// size.  What bounds it now: the gates' sweeps over the chunk in shared
// memory (each reads and writes the chunk; two- and three-qubit gates on
// the two lowest bits a float at a time), which kept it at 6 times the
// function's own float32 bound and 3.6 times the route's device-memory
// traffic at 17q-1l and C = 256 on an H100.
#include <cooperative_groups.h>

#include "dmem.cuh"
#include "statevector.cuh"

namespace vqc {

// The circuit's evolution from |0...0>, shared by both kernels: the
// warp's state in its slice of dynamic shared memory.
__device__ __forceinline__ WarpState evolve_circuit(float* smem, const float* theta,
                                                    const float* data, long c, int n_theta,
                                                    int n_data, const int* ops,
                                                    const float* consts, int n_ops,
                                                    int n_qubits, int warp, int lane) {
  const int dim = 1 << n_qubits;
  const WarpState s{smem + static_cast<long>(warp) * 2 * dim,
                    smem + static_cast<long>(warp) * 2 * dim + dim};
  warp_zero(s, dim, lane);
  warp_evolve(ops, consts, n_ops, theta + c * n_theta, data + c * n_data, s, n_qubits, lane);
  return s;
}

__global__ void __launch_bounds__(1024)
fidelity_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                int n_circuits, int n_theta, int n_data,
                const int* __restrict__ ops, const float* __restrict__ consts, int n_ops,
                int n_qubits, float* __restrict__ p0_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  // The whole warp is one circuit, so this exit is warp-uniform: a warp
  // past the batch (the ragged last block) leaves before any shuffle, and
  // no block barrier follows.
  if (c >= n_circuits) return;
  const WarpState s = evolve_circuit(smem, theta, data, c, n_theta, n_data, ops, consts, n_ops,
                                     n_qubits, warp, lane);
  const int dim = 1 << n_qubits;
  float p0 = 0.f;  // ancilla = MSB: the first half of the amplitudes
  for (int a = lane; a < dim / 2; a += 32) p0 += s.re[a] * s.re[a] + s.im[a] * s.im[a];
  p0 = warp_sum(p0);
  if (lane == 0) p0_out[c] = p0;
}

__global__ void __launch_bounds__(1024)
state_kernel(const float* __restrict__ theta, const float* __restrict__ data,
             int n_circuits, int n_theta, int n_data,
             const int* __restrict__ ops, const float* __restrict__ consts, int n_ops,
             int n_qubits, float* __restrict__ re_out, float* __restrict__ im_out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long c = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (c >= n_circuits) return;  // warp-uniform, as in fidelity_kernel
  const WarpState s = evolve_circuit(smem, theta, data, c, n_theta, n_data, ops, consts, n_ops,
                                     n_qubits, warp, lane);
  const int dim = 1 << n_qubits;
#pragma unroll 1
  for (int a = lane; a < dim; a += 32) {
    re_out[c * dim + a] = s.re[a];
    im_out[c * dim + a] = s.im[a];
  }
}

// --------------------------------------------------- device-memory route
constexpr int kPassFields = 6;  // op lo, op hi, local mask, zero mask (two halves each)

// This thread's share of the chunk's P(0): the amplitudes with the ancilla
// (bit n - 1) at 0.
__device__ __forceinline__ float chunk_p0(const Chunk& ch, const float4* sre, const float4* sim,
                                          int n) {
  float acc = 0.f;
#pragma unroll 1
  for (int e = threadIdx.x; e < ch.size / 4; e += blockDim.x) {
    if (ch.at(4 * e) >> (n - 1) & 1) continue;
    const float4 r = sre[e], m = sim[e];
    acc += r.x * r.x + m.x * m.x + r.y * r.y + m.y * m.y + r.z * r.z + m.z * m.z + r.w * r.w +
           m.w * m.w;
  }
  return acc;
}

// One circuit's evolution on the device-memory route, by the blocks of its
// cluster; P(0) into *p0 (fidelity) or the state left in (re, im).
template <bool kState>
__device__ __forceinline__ void dmem_evolve(const float* th, const float* dt, const int* ops,
                                            const float* consts, int n_ops, const int* passes,
                                            int n_passes, int n, int k, float* re, float* im,
                                            float* p0) {
  extern __shared__ float smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, nt = blockDim.x, size = 1 << k;
  float* sre = smem;                                    // [2^k]
  float* sim = sre + size;                              // [2^k]
  float4* sre4 = reinterpret_cast<float4*>(sre);
  float4* sim4 = reinterpret_cast<float4*>(sim);
  float* angles = sim + size;                           // [2 * n_ops]
  long long* dep_lo = reinterpret_cast<long long*>(angles + 2 * n_ops);
  long long* dep_hi = dep_lo + kDepLo;
  float* partial = reinterpret_cast<float*>(dep_hi + kDepHi);  // one a warp
  const long long n_chunks = 1LL << (n - k);
  const unsigned long long all = (n == 64 ? ~0ULL : (1ULL << n) - 1);

  for (int j = tid; j < n_ops; j += nt) {
    op_angle(ops + j * kOpFields, consts[j], th, dt, 0.f, angles[2 * j], angles[2 * j + 1]);
  }
  unsigned long long zero = 0;
#pragma unroll 1
  for (int p = 0; p < n_passes; ++p) {
    const int* row = passes + p * kPassFields;
    const unsigned long long local = mask_at(row + 2);
    zero = mask_at(row + 4);
    const bool last = p == n_passes - 1;
    __syncthreads();  // the last pass's chunk is done with the deposit tables
    for (int e = tid; e < kDepLo + kDepHi; e += nt) {
      if (e < kDepLo) dep_lo[e] = deposit(e, local);
      else dep_hi[e - kDepLo] = deposit(static_cast<long long>(e - kDepLo) << 8, local);
    }
    __syncthreads();
#pragma unroll 1
    for (long long c = rank; c < n_chunks; c += n_blocks) {
      const Chunk ch{deposit(c, all & ~local), dep_lo, dep_hi, size};
      if (ch.base & zero) {  // every amplitude of the chunk is 0, before and after
        if (kState && last) store_chunk(ch, nullptr, nullptr, re, im);
        continue;
      }
      if (!kState && last && (ch.base >> (n - 1) & 1)) continue;  // the ancilla-1 half
      load_chunk(ch, sre4, sim4, re, im, zero, p == 0);
      __syncthreads();
      chunk_gates(ops, angles, row[0], row[1], sre, sim, k);
      if (!kState && last) {
        const float acc = block_sum(chunk_p0(ch, sre4, sim4, n), partial);
        if (tid == 0) __stcg(re + ch.base, acc);  // this chunk's first amplitude, read
      } else {
        store_chunk(ch, sre4, sim4, re, im);
      }
      __syncthreads();  // the chunk in shared memory is free
    }
    cluster.sync();  // this pass's stores before the next pass's loads
  }
  if (!kState && rank == 0) {
    // the live chunks' partials of the last pass, in chunk order
    const unsigned long long local = mask_at(passes + (n_passes - 1) * kPassFields + 2);
    float acc = 0.f;
#pragma unroll 1
    for (long long c = tid; c < n_chunks; c += nt) {
      const long long base = deposit(c, all & ~local);
      if (!(base & zero) && !(base >> (n - 1) & 1)) acc += __ldcg(re + base);
    }
    acc = block_sum(acc, partial);
    if (tid == 0) *p0 = acc;
  }
}

// Circuit blockIdx.x / cluster size; its state at re + c * stride (and im).
__global__ void __launch_bounds__(1024)
fidelity_dmem_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                     int n_theta, int n_data, const int* __restrict__ ops,
                     const float* __restrict__ consts, int n_ops, const int* __restrict__ passes,
                     int n_passes, int n_qubits, int k, float* re, float* im, long long stride,
                     float* __restrict__ p0_out) {
  const long long c = blockIdx.x / cooperative_groups::this_cluster().num_blocks();
  dmem_evolve<false>(theta + c * n_theta, data + c * n_data, ops, consts, n_ops, passes,
                     n_passes, n_qubits, k, re + c * stride, im + c * stride, p0_out + c);
}

__global__ void __launch_bounds__(1024)
state_dmem_kernel(const float* __restrict__ theta, const float* __restrict__ data, int n_theta,
                  int n_data, const int* __restrict__ ops, const float* __restrict__ consts,
                  int n_ops, const int* __restrict__ passes, int n_passes, int n_qubits, int k,
                  float* re, float* im, long long stride) {
  const long long c = blockIdx.x / cooperative_groups::this_cluster().num_blocks();
  dmem_evolve<true>(theta + c * n_theta, data + c * n_data, ops, consts, n_ops, passes, n_passes,
                    n_qubits, k, re + c * stride, im + c * stride, nullptr);
}

}  // namespace vqc

// The device-memory route: fidelity (P(0) into p0_out, the states in a
// workspace) or state (into re, im); circuit c's state at re + c * stride
// and im + c * stride; one cluster of `cluster` blocks a circuit.
extern "C" int vqc_dmem_launch(int want_state, const float* theta, const float* data,
                               int n_circuits, int n_theta, int n_data, const int* ops,
                               const float* consts, int n_ops, const int* passes, int n_passes,
                               int n_qubits, int k, float* re, float* im, long long stride,
                               float* p0_out, int cluster, int threads, int smem_bytes,
                               void* stream) {
  if (k < 3 || k > 14 || k > n_qubits || cluster < 1 || n_circuits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_circuits) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (want_state) {
    err = vqc::allow_smem(vqc::state_dmem_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, vqc::state_dmem_kernel, theta, data, n_theta, n_data, ops,
                             consts, n_ops, passes, n_passes, n_qubits, k, re, im, stride);
  } else {
    err = vqc::allow_smem(vqc::fidelity_dmem_kernel, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(&cfg, vqc::fidelity_dmem_kernel, theta, data, n_theta, n_data, ops,
                             consts, n_ops, passes, n_passes, n_qubits, k, re, im, stride, p0_out);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vqc_fidelity_launch(const float* theta, const float* data, int n_circuits,
                                   int n_theta, int n_data, const int* ops, const float* consts,
                                   int n_ops, int n_qubits, float* p0_out, int warps,
                                   int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::fidelity_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_circuits + warps - 1) / warps);
  vqc::fidelity_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits, p0_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vqc_state_launch(const float* theta, const float* data, int n_circuits,
                                int n_theta, int n_data, const int* ops, const float* consts,
                                int n_ops, int n_qubits, float* re_out, float* im_out, int warps,
                                int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::state_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_circuits + warps - 1) / warps);
  vqc::state_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_circuits, n_theta, n_data, ops, consts, n_ops, n_qubits, re_out, im_out);
  return static_cast<int>(cudaGetLastError());
}
