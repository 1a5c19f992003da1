// Prefix-reuse shift-bank kernel (kernel 3 of the port).
//
// Replaces repro/kernels/vqc_statevector.py::_shiftbank_kernel, the
// single-sweep branch of vqc_shift_fidelity.  For a SWAP-test circuit the
// fidelity is |<psi_d|psi_t>|^2 of two m-qubit register states, so each
// sample of the implicit bank runs:
//   1. the data register's ops once, into chi's slot (psi_d seeds chi);
//   2. the trainable register forward with base angles, copying the state
//      into a checkpoint slot before each anchored parameter's first gate;
//   3. the base fidelity f0, written to every row that takes it;
//   4. the spill tile kernel's walk (ShiftWalk in statevector.cuh) as one
//      tile: chi walked backward through the inverted train ops down to
//      the lowest anchor; at each anchor, every variant anchored there
//      replays its parameter's [first, last] span from its checkpoint with
//      the shift added to that parameter's gates, and writes |<chi|v>|^2.
// The shift plan arrives as tables (_WalkTable in vqc_statevector.py,
// without tiles), staged in shared memory once per block, so one build
// serves every circuit and group set.
//
// One warp per sample, shift_geometry's SHIFT_WARPS samples a block (fewer
// where the checkpoints do not fit); per sample (n_ckpt + 3) states of
// 2 * 4 * 2^m bytes: the running state, chi (the data state until the
// walk), one variant and the checkpoints.  Each gate is one 32-wide pass
// (at m = 3 a one-qubit gate has 4 pairs, so 28 lanes idle: the kernel is
// latency-bound, a chain of dependent steps per sample, and 576 samples
// make 576 warps over every SM).
//
// Bound on an H100: per sample (P + D) * 4 bytes in and 4 bytes per
// requested row out, against the float32 arithmetic of every gate
// application, so arithmetic bounds it.  The one-thread kernel this
// replaced walked each sample's state serially (2^(m-1) dependent shared-
// memory steps a gate) in blocks of 128 samples: 5 blocks on 5 SMs at
// B = 576.
#include "statevector.cuh"

namespace vqc {

__global__ void __launch_bounds__(1024)
shiftbank_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                 int n_samples, int n_theta, int n_data,
                 const int* __restrict__ itab, const float* __restrict__ ftab, int m,
                 int n_data_ops, int n_train_ops, int n_variants, int n_f0_rows, int lowest,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  float* states;
  const WalkTables tab =
      stage_tables(smem, itab, ftab, n_data_ops, n_train_ops, n_variants, states);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long b = static_cast<long>(blockIdx.x) * warps + warp;
  // warp-uniform (a warp is one sample): the ragged last block's idle warps
  // leave after the block's one barrier, before any shuffle
  if (b >= n_samples) return;
  const int dim = 1 << m;
  const long n = n_samples;
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;
  const ShiftWalk w(tab, th, dt, states, warps, warp, lane, m, n_train_ops, n_variants);
  const WarpState run = w.slot(0), chi = w.slot(1);

  // 1. data register: one theta-independent pass.
  warp_zero(chi, dim, lane);
  warp_evolve(tab.data_ops, tab.data_consts, n_data_ops, th, dt, chi, m, lane);
  // 2. forward pass with base angles, checkpointing before first gates.
  warp_zero(run, dim, lane);
  w.advance(run, 0, n_train_ops);
  // 3. base fidelity: group 0 and every shift of an unused parameter.
  const float f0 = warp_inner(chi, run, dim, lane);
  const int* f0_rows = itab + WalkTables::staged_ints(n_data_ops, n_train_ops, n_variants);
  if (lane == 0) {
    for (int r = 0; r < n_f0_rows; ++r) out[f0_rows[r] * n + b] = f0;
  }
  // 4. backward walk of chi; variants arrive in descending anchor order.
  int vi = 0;
  w.walk(n_train_ops, lowest, false, vi, out, n, b);
}

}  // namespace vqc

extern "C" int vqc_shiftbank_launch(const float* theta, const float* data, int n_samples,
                                    int n_theta, int n_data, const int* itab,
                                    const float* ftab, int m, int n_data_ops,
                                    int n_train_ops, int n_variants, int n_f0_rows, int lowest,
                                    float* out, int warps, int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::shiftbank_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + warps - 1) / warps);
  vqc::shiftbank_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops,
      n_variants, n_f0_rows, lowest, out);
  return static_cast<int>(cudaGetLastError());
}
