// Spilled prefix-reuse shift kernels (kernels 4 and 5 of the port).
//
// Replace repro/kernels/vqc_statevector.py::_shift_forward_kernel and
// ::_shift_tile_kernel, the spilled branch of vqc_shift_fidelity, taken
// when the single sweep's checkpoints do not fit a block of SWEEP_MIN_WARPS
// samples (_shift_route in vqc_statevector.py).  The train-op sequence is
// cut into depth tiles (spill_tiling).  Both kernels run one WARP per
// sample in blocks of a few samples, after staging the plan tables
// (_WalkTable; statevector.cuh) in shared memory behind the block's one
// barrier:
//
//   shift_forward_kernel (forward_geometry): the data-register pass, then
//     the train forward pass with base angles, the fidelity kernel's
//     evolution loop (warp_evolve) run twice.  Writes the data state (the
//     seed of chi), the prefix state at each tile's first op (its
//     boundary), and f0 to every row that takes it.  Shared memory per
//     sample: the data and running states (the one-thread kernel it
//     replaced needed 32 samples' and refused m >= 9; the pair runs up to
//     m = 12, where the tile kernel's four states of one sample fit; wider
//     registers take the device-memory walk of vqc_shift_dmem.cu).
//   shift_tile_kernel (spill_tiling's tb), ONE launch for every tile,
//     deepest first: load the tile's boundary into the running state,
//     advance it through the tile re-deriving the tile's checkpoints, then
//     the shift walk (ShiftWalk::walk) from hi - 1 down to lo; chi stays in
//     shared memory from one tile to the next.  Shared memory per sample:
//     (n_ckpt + 3) * 2 * 4 * 2^m bytes, the fullest tile's checkpoints and
//     the running state, chi and one variant.  The next boundary is loaded
//     when its tile starts (no prefetch).
//
// Boundaries and the chi seed live in device memory as [tile][re/im][amp]
// [sample]: a warp writes and reads a state as 2 * 2^m words n_samples
// apart (warp_store, warp_load), a sector each.
//
// Per sample the gates apply in the single sweep's order with the same
// gate code (warp_apply, rot1/rot2), so the pair's rows equal the single
// sweep's bit for bit.
//
// Bound on an H100: per sample the pair moves (P + D) angles twice, the
// data state and n_tiles boundaries out and back in, 2 * (n_tiles + 1)
// states of 2 * 4 * 2^m bytes in all, plus one float per row; the float32
// arithmetic of the gate applications (the recompute pass included) is
// larger at these widths, so arithmetic bounds it.
//
// The walk's design against the one-thread-per-sample kernels these
// replaced (which walked each state serially through shared memory, 2^(m-1)
// dependent steps a gate, in blocks of up to 128 samples on a few SMs):
// each gate is one 32-wide pass, each checkpoint copy and inner product is
// 32-wide, the latter ending in a warp reduction; blocks of a few samples
// spread 576 samples over every SM; the tables sit in shared memory and
// each train op's base cos/sin and each variant's shifted cos/sin are
// computed once per sample and broadcast with __shfl_sync; a variant whose
// parameter drives one gate applies it and takes the inner product in one
// pass (warp_apply_inner); the gate code is inlined (no call, no spills).
#include "statevector.cuh"

namespace vqc {

__global__ void __launch_bounds__(1024)
shift_forward_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                     int n_samples, int n_theta, int n_data, const int* __restrict__ itab,
                     const float* __restrict__ ftab, int m, int n_data_ops, int n_train_ops,
                     int n_tiles, int n_variants, int n_f0_rows, float* __restrict__ out,
                     float* __restrict__ d_out, float* __restrict__ bnd_out) {
  extern __shared__ float smem[];
  float* states;
  const WalkTables tab =
      stage_tables(smem, itab, ftab, n_data_ops, n_train_ops, n_variants, states);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long b = static_cast<long>(blockIdx.x) * warps + warp;
  if (b >= n_samples) return;  // warp-uniform, after the block's one barrier
  const int dim = 1 << m;
  const long n = n_samples;
  const WarpState d{states + static_cast<long>(warp) * 2 * dim,
                    states + static_cast<long>(warp) * 2 * dim + dim};
  const WarpState t{states + static_cast<long>(warps + warp) * 2 * dim,
                    states + static_cast<long>(warps + warp) * 2 * dim + dim};
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;

  warp_zero(d, dim, lane);
  warp_evolve(tab.data_ops, tab.data_consts, n_data_ops, th, dt, d, m, lane);
  warp_store(d_out, d, dim, n, b, lane);
  warp_zero(t, dim, lane);
  warp_evolve(tab.train_ops, tab.train_consts, n_train_ops, th, dt, t, m, lane, [&](int k) {
    const int tile = tab.bnd_of[k];
    if (tile >= 0) warp_store(bnd_out + static_cast<long>(tile) * 2 * dim * n, t, dim, n, b, lane);
  });
  const float f0 = warp_inner(d, t, dim, lane);
  const int* f0_rows =
      itab + WalkTables::staged_ints(n_data_ops, n_train_ops, n_variants) + n_tiles * kTileFields;
  if (lane == 0) {
    for (int r = 0; r < n_f0_rows; ++r) out[f0_rows[r] * n + b] = f0;
  }
}

__global__ void __launch_bounds__(1024)
shift_tile_kernel(const float* __restrict__ theta, const float* __restrict__ data,
                  int n_samples, int n_theta, int n_data, const int* __restrict__ itab,
                  const float* __restrict__ ftab, int m, int n_data_ops, int n_train_ops,
                  int n_tiles, int n_variants, const float* __restrict__ chi_in,
                  const float* __restrict__ bnd, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* states;
  const WalkTables tab =
      stage_tables(smem, itab, ftab, n_data_ops, n_train_ops, n_variants, states);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long b = static_cast<long>(blockIdx.x) * warps + warp;
  if (b >= n_samples) return;  // warp-uniform, after the block's one barrier
  const int dim = 1 << m;
  const long n = n_samples;
  const ShiftWalk w(tab, theta + b * n_theta, data + b * n_data, states, warps, warp, lane, m,
                    n_train_ops, n_variants);
  const WarpState run = w.slot(0);
  const int* tiles = itab + WalkTables::staged_ints(n_data_ops, n_train_ops, n_variants);

  warp_load(w.slot(1), chi_in, dim, n, b, lane);
  int vi = 0;
  for (int ti = 0; ti < n_tiles; ++ti) {
    const int* tile = tiles + ti * kTileFields;  // read once a tile: left in device memory
    const int lo = tile[0], hi = tile[1], last = tile[2];
    // re-derive this tile's checkpoints from its boundary prefix state
    warp_load(run, bnd + static_cast<long>(tile[3]) * 2 * dim * n, dim, n, b, lane);
    w.advance(run, lo, last);
    w.checkpoint(run, last);
    // chi at lo seeds the next (shallower) tile
    w.walk(hi, lo, ti + 1 < n_tiles, vi, out, n, b);
  }
}

}  // namespace vqc

extern "C" int vqc_shift_forward_launch(const float* theta, const float* data, int n_samples,
                                        int n_theta, int n_data, const int* itab,
                                        const float* ftab, int m, int n_data_ops,
                                        int n_train_ops, int n_tiles, int n_variants,
                                        int n_f0_rows, float* out, float* d_out, float* bnd_out,
                                        int warps, int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::shift_forward_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + warps - 1) / warps);
  vqc::shift_forward_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops, n_tiles,
      n_variants, n_f0_rows, out, d_out, bnd_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vqc_shift_tile_launch(const float* theta, const float* data, int n_samples,
                                     int n_theta, int n_data, const int* itab, const float* ftab,
                                     int m, int n_data_ops, int n_train_ops, int n_tiles,
                                     int n_variants, const float* chi_in, const float* bnd,
                                     float* out, int warps, int smem_bytes, void* stream) {
  const cudaError_t err = vqc::allow_smem(vqc::shift_tile_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + warps - 1) / warps);
  vqc::shift_tile_kernel<<<grid, warps * 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_samples, n_theta, n_data, itab, ftab, m, n_data_ops, n_train_ops, n_tiles,
      n_variants, chi_in, bnd, out);
  return static_cast<int>(cudaGetLastError());
}
