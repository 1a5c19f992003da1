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
//   One block a sample.  The walk arrives as a program of passes built on
//   the host (_shift_dmem_walk): the data run into chi (slot 0), the
//   forward runs between checkpoints (each storing the next checkpoint,
//   slot 2 + i), f0, and in descending anchor order the inverse runs of chi
//   and each variant's replay of its parameter's span from its checkpoint
//   with the shift on that parameter's gates, ending in |<chi|v>|^2 (slot 1
//   holds a multi-pass replay's variant between its passes).  A run is cut
//   into passes of at most k = 13 local qubits (dmem_plan's cutting, the
//   three lowest-order qubits always local), so the state splits into
//   2^(m - k) chunks of 2^k amplitudes (64 KB).  A pass applies its gates
//   to each chunk in shared memory with chunk_gates (the gate arithmetic of
//   every kernel of the port: rot1, rot2, dot2).  Pass angles come from a
//   per-sample table of cos/sin built once in shared memory (base angles of
//   the data and train ops, and theta[j] + shift for each variant), negated
//   sin for the inverted ops of chi.  Shared memory holds three 64 KB
//   regions besides the tables (one block an SM), used by the register's
//   width:
//
//   m = k (one chunk a state: 27-qubit QuClassi, the trained shape).  Chi
//   and two state buffers, each a whole state.  Chi lives in its region for
//   the whole walk: the data run builds it there, its inverse runs apply in
//   place, f0 and every variant read it there, so slot 0 never touches
//   device memory.  The checkpoints move by TMA bulk copies (cp.async.bulk,
//   re then im, each contiguous): a forward run's store goes back
//   asynchronously, and a variant's checkpoint arrives on its buffer's
//   mbarrier, issued a pass or more ahead so that it overlaps the gates and
//   inner products between.  Which buffer each pass works in, what it
//   waits for, copies or loads is the host's staging plan
//   (_shift_dmem_stage): where the next pass that needs a buffer replays
//   from the same checkpoint (the two shifts of a parameter, f0 and the
//   deepest parameter), the pass works on a copy and leaves the staged
//   checkpoint for it; a forward run works on a copy of the state the run
//   before it is still storing.  At 27q-3l a sample moves 147 chunks, not
//   the 518 of the kernel this one redesigned.
//
//   m = k + 1 (29 qubits).  Chi (128 KB) stays resident in two regions;
//   each chunk of a pass arrives in the third by cp.async (16-byte copies
//   of 32-byte sectors) or from resident chi, and chi's runs gather and
//   scatter there.  No region is left for a second chunk, so the copies
//   are not overlapped with the gates.
//
//   m > k + 1 (31-33 qubits).  Every state in device memory; the pass loop
//   is double-buffered (chunk c + 1 arrives by cp.async in the second
//   buffer while chunk c computes) and chi's chunk for an inner product
//   arrives the same way in the third region.
//
// The program's tables (passes, the staging plan at m = k, pass ops, angle
// references) are copied into shared memory first where they fit beside
// the regions (every QuClassi plan of 27-33 qubits and 1-3 layers), so that
// no pass waits on device memory for its own description.
//
// Inner products sum in a fixed order, as the kernel this one redesigned
// did with its 512 threads: thread t its float4 elements t, t + 512, ... in
// turn, a block reduction of warp sums in warp order (block_sum2), then the
// chunks' partials in chunk order.  A lane's rows therefore depend only on
// its own angles: not on the batch, nor on how many samples a launch takes
// (the wrapper splits a batch by samples when their scratch would exceed
// SHIFT_DMEM_WORKSPACE_BYTES); and they are that kernel's bits.
//
// Bound on an H100: the function moves only the angles in and one float a
// row out; its float32 arithmetic (the gate applications and the inner
// products over 2^m amplitudes) is the bound.  The route's own traffic
// (shift_dmem_traffic_bytes: 9.6 MB a sample at 27q-3l, the checkpoints'
// stores and loads, which do not fit the 50 MB L2) takes 3.3 ms at 3.35
// TB/s for a training step's 1,152 samples; the kernel takes longer, bound
// by its passes' sweeps of the state in shared memory with one block an SM
// (about 300 passes a sample, each sweeping 64 KB two to four times:
// tools/shift_dmem_trace.py times each kind of pass).
#include <cstdint>

#include "dmem.cuh"
#include "statevector.cuh"

namespace vqc {

constexpr int kWalkPassFields = 7;  // source, destination, row, op lo, op hi, local mask (two halves)
// a pass's staging plan at m = k: work buffer, fetch buffer and slot (loaded
// and waited for before the pass), wait buffer, copy-from buffer, load
// buffer and slot (issued after the pass's buffer is made); -1 for none
constexpr int kStageFields = 7;
constexpr int kAllF0Rows = -2;      // a pass row that writes every base-fidelity row
// threads a block, one block an SM (three 64 KB regions); they sum each
// inner product in the order of the kernel this one redesigned, which had
// 512 threads a block
constexpr int kThreads = 512;

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the mbarrier's phase of ``parity``; a load that has not landed
// after about ten seconds traps (the launch fails and the wrapper raises)
// rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (20LL << 30)) __trap();
  } while (!done);
}

// A state of 2^m amplitudes (re then im, each contiguous) from device memory
// into shared memory by two bulk copies, completing on ``bar``.
__device__ __forceinline__ void bulk_load_state(float* dst, const float* src, int amps,
                                                uint32_t bar) {
  const uint32_t bytes = 4u * amps;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(2 * bytes)
               : "memory");
  for (int h = 0; h < 2; ++h) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(dst + h * amps)),
        "l"(src + h * amps), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// The state back to device memory by two bulk copies, one bulk group.
__device__ __forceinline__ void bulk_store_state(float* dst, const float* src, int amps) {
  for (int h = 0; h < 2; ++h) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dst + h * amps),
                 "r"(smem_u32(src + h * amps)), "r"(4u * amps)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Every bulk store written to device memory, and visible to the bulk loads
// that follow.
__device__ __forceinline__ void bulk_wait_written() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- chunk work

// block_sum of two values at once: each through the same warp sums and
// warp order as block_sum alone (the same bits), one pair of barriers.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* partial) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // partial is free
  if (lane == 0) {
    partial[warp] = a;
    partial[32 + warp] = b;
  }
  __syncthreads();
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  return make_float2(warp_sum(in ? partial[lane] : 0.f), warp_sum(in ? partial[32 + lane] : 0.f));
}

// <chi|v> over a chunk of 2^k amplitudes, summed over the block in the
// fixed order above: v staged in shared memory, chi in shared memory at the
// same element (gather false) or, resident whole, at the chunk's amplitudes
// (gather true).
__device__ __noinline__ float2 chunk_inner(const Chunk ch, bool gather, const float4* vre,
                                           const float4* vim, const float4* cre,
                                           const float4* cim, float* partial) {
  float ip_re = 0.f, ip_im = 0.f;
#pragma unroll 4
  for (int e = threadIdx.x; e < ch.size / 4; e += kThreads) {
    const long long g = gather ? ch.at(4 * e) >> 2 : e;
    const float4 xr = cre[g], xi = cim[g];
    const float4 r = vre[e], m = vim[e];
    accumulate(xr.x, xi.x, r.x, m.x, ip_re, ip_im);
    accumulate(xr.y, xi.y, r.y, m.y, ip_re, ip_im);
    accumulate(xr.z, xi.z, r.z, m.z, ip_re, ip_im);
    accumulate(xr.w, xi.w, r.w, m.w, ip_re, ip_im);
  }
  return block_sum2(ip_re, ip_im, partial);
}

// A whole state in shared memory: |0...0> (src == nullptr) or a copy.
__device__ __noinline__ void make_state(float4* re, float4* im, const float4* sre,
                                        const float4* sim, int n4) {
#pragma unroll 1
  for (int e = threadIdx.x; e < n4; e += blockDim.x) {
    float4 r{}, m{};
    if (sre) {
      r = sre[e];
      m = sim[e];
    } else if (e == 0) {
      r.x = 1.f;
    }
    re[e] = r;
    im[e] = m;
  }
}

// A chunk into shared memory: |0...0> made there (first), gathered from
// resident chi in shared memory (rre), or copied by cp.async from device
// memory (re, im; the caller commits and waits).
__device__ __noinline__ void fill_chunk(const Chunk ch, float4* sre, float4* sim, const float* re,
                                        const float* im, const float4* rre, const float4* rim,
                                        bool first) {
#pragma unroll 1
  for (int e = threadIdx.x; e < ch.size / 4; e += blockDim.x) {
    const long long g = ch.at(4 * e);
    if (first) {
      sre[e] = make_float4(g == 0 ? 1.f : 0.f, 0.f, 0.f, 0.f);
      sim[e] = float4{};
    } else if (rre) {
      sre[e] = rre[g >> 2];
      sim[e] = rim[g >> 2];
    } else {
      cp_async16(sre + e, re + g);
      cp_async16(sim + e, im + g);
    }
  }
}

// A chunk back to resident chi in shared memory (rre) or to device memory.
__device__ __noinline__ void drain_chunk(const Chunk ch, const float4* sre, const float4* sim,
                                         float* re, float* im, float4* rre, float4* rim) {
#pragma unroll 1
  for (int e = threadIdx.x; e < ch.size / 4; e += blockDim.x) {
    const long long g = ch.at(4 * e);
    if (rre) {
      rre[g >> 2] = sre[e];
      rim[g >> 2] = sim[e];
    } else {
      __stcg(reinterpret_cast<float4*>(re + g), sre[e]);
      __stcg(reinterpret_cast<float4*>(im + g), sim[e]);
    }
  }
}

__device__ __forceinline__ void write_rows(float f, int out_row, const int* f0_rows, int n_f0_rows,
                                           float* out, long long out_stride, long long col) {
  if (out_row == kAllF0Rows) {
    for (int r = 0; r < n_f0_rows; ++r) out[f0_rows[r] * out_stride + col] = f;
  } else {
    out[out_row * out_stride + col] = f;
  }
}

// Sample blockIdx.x of the launch: its angles at theta + b * n_theta, its
// scratch at scratch + b * sample_floats (the slots from the first one kept
// in device memory: 2 at m = k, 1 at m = k + 1, else 0), its rows in column
// col0 + b of out (out_stride columns).  stage: the staging plan (m = k;
// null where m > k).  tables_in_smem: the program's tables (passes, stage
// where there is one, pass_ops, pass_refs) are copied into shared memory
// first, where the host found room for them,
// so that no pass waits on device memory for its own description.
__global__ void __launch_bounds__(kThreads, 1)
shift_dmem_kernel(const float* __restrict__ theta, const float* __restrict__ data, int n_theta,
                  int n_data, const int* __restrict__ base_ops,
                  const float* __restrict__ base_consts, int n_base,
                  const int* __restrict__ var_param, const float* __restrict__ var_shift,
                  int n_var, const int* __restrict__ passes, int n_passes,
                  const int* __restrict__ stage, const int* __restrict__ pass_ops,
                  const int* __restrict__ pass_refs, int max_pass_ops,
                  const int* __restrict__ f0_rows, int n_f0_rows, int m, int k, float* scratch,
                  long long sample_floats, float* __restrict__ out, long long out_stride,
                  long long col0, int tables_in_smem) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, size = 1 << k;
  const long long b = blockIdx.x, dim = 1LL << m;
  const float* th = theta + b * n_theta;
  const float* dt = data + b * n_data;
  const int lo_slot = m == k ? 2 : m == k + 1 ? 1 : 0;  // slots below it never leave shared memory
  float* mine = scratch + b * sample_floats - lo_slot * 2 * dim;  // slot s at mine + s * 2 * dim
  // three regions of one chunk's (re, im), then the tables
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * size);  // [2]: buffers 1 and 2 (m = k)
  float* partial = reinterpret_cast<float*>(bar + 2);              // two a warp
  long long* dep_lo = reinterpret_cast<long long*>(partial + 64);
  long long* dep_hi = dep_lo + kDepLo;
  float* ang = reinterpret_cast<float*>(dep_hi + kDepHi);  // [2 * (n_base + n_var)]
  float* pang = ang + 2 * (n_base + n_var);                // [2 * max_pass_ops]
  if (tables_in_smem) {  // after pang: passes, stage (m = k), pass_ops, pass_refs
    const int n_ops_total = passes[(n_passes - 1) * kWalkPassFields + 4];
    const int np = n_passes * kWalkPassFields, no = n_ops_total * kOpFields;
    const int ns = m == k ? n_passes * kStageFields : 0, nt = np + ns;
    int* t = reinterpret_cast<int*>(pang + 2 * max_pass_ops);
    for (int e = tid; e < nt + no + n_ops_total; e += blockDim.x) {
      t[e] = e < np ? passes[e] : e < nt ? stage[e - np] : e < nt + no
             ? pass_ops[e - nt] : pass_refs[e - nt - no];
    }
    passes = t;
    if (ns) stage = t + np;
    pass_ops = t + nt;
    pass_refs = t + nt + no;
  }
  const unsigned long long all = (1ULL << m) - 1;
  const long long n_chunks = 1LL << (m - k);
  auto region = [&](int i) { return smem + 2 * size * i; };

  if (m == k && tid == 0) {
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar + i)), "r"(1)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < n_base; j += blockDim.x) {
    op_angle(base_ops + j * kOpFields, base_consts[j], th, dt, 0.f, ang[2 * j], ang[2 * j + 1]);
  }
  for (int v = tid; v < n_var; v += blockDim.x) {
    const float a = th[var_param[v]] + var_shift[v];
    ang[2 * (n_base + v)] = cosf(a / 2.f);
    ang[2 * (n_base + v) + 1] = sinf(a / 2.f);
  }
  __syncthreads();  // the tables copied: each pass reads its rows before its first barrier
  unsigned long long staged_mask = 0;  // the local mask the deposit tables hold (0: none)
  unsigned phase = 0;                  // bit i: parity of buffer i's next load (m = k)
  int recent = -1;                     // the buffer the latest bulk store may still read (m = k)
  unsigned older = 0;                  // bit i: an earlier bulk store may still read buffer i
  bool stores_open = false;            // a bulk store not yet known written (m = k)
#pragma unroll 1
  for (int p = 0; p < n_passes; ++p) {
    const int* row = passes + p * kWalkPassFields;
    const int* st = m == k ? stage + p * kStageFields : nullptr;
    if (m == k && (recent >= 0 || older)) {  // no buffer is written while a store reads it
      const unsigned writes = (1u << st[0]) | (st[1] >= 0 ? 1u << st[1] : 0u) |
                              (st[5] >= 0 ? 1u << st[5] : 0u);
      if (recent >= 0 && (writes >> recent & 1u)) {
        if (tid == 0) bulk_wait_read();
        recent = -1;
        older = 0;
      } else if (writes & older) {
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        older = 0;
      }
    }
    const int src = row[0], dst = row[1], out_row = row[2], lo = row[3], n_ops = row[4] - lo;
    const int* ops = pass_ops + lo * kOpFields;
    const unsigned long long local = mask_at(row + 5);
    __syncthreads();  // the last pass is done with pang and the deposit tables
    if (m == k && st[1] >= 0) {  // fetch this pass's checkpoint
      if (tid == 0) {
        if (stores_open) bulk_wait_written();
        bulk_load_state(region(st[1]), mine + st[2] * 2 * dim, size, smem_u32(bar + st[1] - 1));
      }
      if (stores_open) recent = -1, older = 0, stores_open = false;
    }
    if (m > k && local != staged_mask) {
      for (int e = tid; e < kDepLo + kDepHi; e += blockDim.x) {
        if (e < kDepLo) dep_lo[e] = deposit(e, local);
        else dep_hi[e - kDepLo] = deposit(static_cast<long long>(e - kDepLo) << 8, local);
      }
      staged_mask = local;
    }
    for (int j = tid; j < n_ops; j += blockDim.x) {
      const int ref = pass_refs[lo + j], a = ref >> 1;
      pang[2 * j] = ang[2 * a];
      pang[2 * j + 1] = (ref & 1) ? -ang[2 * a + 1] : ang[2 * a + 1];
    }

    if (m == k) {
      // the whole state in region ``work``: chi's own (0) or a buffer
      const int work = st[0], wait = st[3], from = st[4], load = st[5];
      float* w = region(work);
      if (wait >= 0) {
        mbar_wait(smem_u32(bar + wait - 1), (phase >> wait) & 1u);
        phase ^= 1u << wait;
      }
      if (src < 0 || from >= 0) {
        const float* f = from >= 0 ? region(from) : nullptr;
        make_state(reinterpret_cast<float4*>(w), reinterpret_cast<float4*>(w + size),
                   reinterpret_cast<const float4*>(f),
                   reinterpret_cast<const float4*>(f ? f + size : nullptr), size / 4);
      }
      __syncthreads();  // pang, and the state made
      if (load >= 0) {
        if (tid == 0) {
          if (stores_open) bulk_wait_written();
          bulk_load_state(region(load), mine + st[6] * 2 * dim, size, smem_u32(bar + load - 1));
        }
        if (stores_open) recent = -1, older = 0, stores_open = false;
      }
      chunk_gates(ops, pang, 0, n_ops, w, w + size, k);
      if (dst > 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) bulk_store_state(mine + dst * 2 * dim, w, size);
        if (recent >= 0) older |= 1u << recent;
        recent = work;
        stores_open = true;
      }
      if (out_row != -1) {
        const Chunk ch{0, dep_lo, dep_hi, size};
        const float2 ip = chunk_inner(ch, false, reinterpret_cast<const float4*>(w),
                                      reinterpret_cast<const float4*>(w + size),
                                      reinterpret_cast<const float4*>(smem),
                                      reinterpret_cast<const float4*>(smem + size), partial);
        if (tid == 0) {
          write_rows(ip.x * ip.x + ip.y * ip.y, out_row, f0_rows, n_f0_rows, out, out_stride,
                     col0 + b);
        }
      }
      continue;
    }

    // m > k: chunk by chunk.  Resident (m = k + 1): chi whole in regions 0-1,
    // each chunk in region 2.  Streamed: chunk c in region 1 + (c & 1),
    // chi's chunk for an inner product in region 0.
    __syncthreads();  // pang and the deposit tables
    const bool resident = m == k + 1;
    float4* rre = reinterpret_cast<float4*>(smem);  // resident chi: re [2^m], then im
    float4* rim = rre + dim / 4;
    const float* sre_src = src < 0 ? nullptr : mine + src * 2 * dim;
    const bool src_res = resident && src == 0, dst_res = resident && dst == 0;
    float acc_re = 0.f, acc_im = 0.f;
#pragma unroll 1
    for (long long c = 0; c < n_chunks; ++c) {
      const Chunk ch{deposit(c, all & ~local), dep_lo, dep_hi, size};
      float* w = region(resident ? 2 : 1 + (c & 1));
      float4* w4 = reinterpret_cast<float4*>(w);
      if (c == 0 || resident) {
        fill_chunk(ch, w4, w4 + size / 4, sre_src, sre_src + dim, src_res ? rre : nullptr,
                   rim, src < 0);
      }
      cp_commit();  // chunk c (empty when it came ahead)
      if (out_row != -1 && !resident) {
        const float* chi = mine;  // slot 0
        fill_chunk(ch, reinterpret_cast<float4*>(smem), reinterpret_cast<float4*>(smem + size),
                   chi, chi + dim, nullptr, nullptr, false);
      }
      cp_commit();  // chi's chunk c
      if (!resident && c + 1 < n_chunks) {
        const Chunk next{deposit(c + 1, all & ~local), dep_lo, dep_hi, size};
        float4* n4 = reinterpret_cast<float4*>(region(1 + ((c + 1) & 1)));
        fill_chunk(next, n4, n4 + size / 4, sre_src, sre_src + dim, nullptr, nullptr, src < 0);
      }
      cp_commit();  // chunk c + 1, ahead
      cp_wait<2>();
      __syncthreads();
      chunk_gates(ops, pang, 0, n_ops, w, w + size, k);
      if (dst >= 0) {
        drain_chunk(ch, w4, w4 + size / 4, mine + dst * 2 * dim, mine + dst * 2 * dim + dim,
                    dst_res ? rre : nullptr, rim);
      }
      if (out_row != -1) {
        cp_wait<1>();
        __syncthreads();
        const float4* cre = resident ? rre : reinterpret_cast<const float4*>(smem);
        const float4* cim = resident ? rim : reinterpret_cast<const float4*>(smem + size);
        const float2 ip = chunk_inner(ch, resident, w4, w4 + size / 4, cre, cim, partial);
        acc_re += ip.x;
        acc_im += ip.y;
      }
      __syncthreads();  // the chunk's regions are free
    }
    cp_wait<0>();
    if (out_row != -1 && tid == 0) {
      write_rows(acc_re * acc_re + acc_im * acc_im, out_row, f0_rows, n_f0_rows, out, out_stride,
                 col0 + b);
    }
  }
  if (m == k && tid == 0) bulk_wait_written();  // no store outlives the block
}

}  // namespace vqc

// Samples [col0, col0 + n_samples) of a batch of out_stride: theta and data
// are the launch's own rows, scratch holds sample_floats floats a sample.
extern "C" int vqc_shift_dmem_launch(const float* theta, const float* data, int n_samples,
                                     int n_theta, int n_data, const int* base_ops,
                                     const float* base_consts, int n_base, const int* var_param,
                                     const float* var_shift, int n_var, const int* passes,
                                     int n_passes, const int* stage, const int* pass_ops,
                                     const int* pass_refs, int max_pass_ops, const int* f0_rows,
                                     int n_f0_rows, int m, int k, float* scratch,
                                     long long sample_floats, float* out, long long out_stride,
                                     long long col0, int tables_in_smem, int smem_bytes,
                                     void* stream) {
  if (k < 3 || k > 14 || k > m || m - k > 30 || n_samples < 1 ||
      (stage != nullptr) != (m == k) || reinterpret_cast<uintptr_t>(scratch) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = vqc::allow_smem(vqc::shift_dmem_kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  vqc::shift_dmem_kernel<<<n_samples, vqc::kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      theta, data, n_theta, n_data, base_ops, base_consts, n_base, var_param, var_shift, n_var,
      passes, n_passes, stage, pass_ops, pass_refs, max_pass_ops, f0_rows, n_f0_rows, m, k,
      scratch, sample_floats, out, out_stride, col0, tables_in_smem);
  return static_cast<int>(cudaGetLastError());
}
