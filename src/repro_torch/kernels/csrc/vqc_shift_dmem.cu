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
//   every kernel of the port: rot1, rot2, dot2), or at m = k in one of the
//   one-sweep forms below.  Pass angles come from a per-sample table of
//   cos/sin built once in shared memory (base angles of the data and train
//   ops, and theta[j] + shift for each variant; at m = k one entry for each
//   pass op), negated sin for the inverted ops of chi.  Shared memory holds
//   three 64 KB regions besides the tables (one block an SM), used by the
//   register's width:
//
//   m = k (one chunk a state: 27-qubit QuClassi, the trained shape).  Chi
//   and two state buffers, each a whole state.  Chi lives in its region for
//   the whole walk: the data run builds it there, its inverse runs apply in
//   place, f0 and every variant read it there, so slot 0 never touches
//   device memory.  The checkpoints move by TMA bulk copies (cp.async.bulk,
//   re then im, each contiguous): a forward run's store goes back
//   asynchronously, and a variant's checkpoint arrives on its buffer's
//   mbarrier, issued a pass or more ahead so that it overlaps the passes
//   between.  Which region each pass reads and writes, what it waits for
//   or loads, and its form is the host's staging plan (_shift_dmem_stage).
//   Every pass but the data run sweeps the state once (the one-sweep forms
//   below): a forward run reads its checkpoint's region and writes the
//   other, which its store drains; chi's runs apply in place; a variant or
//   f0 reads its staged checkpoint where it stands and writes nothing, so
//   the checkpoint stays staged for the parameter's other shifts.  At
//   27q-3l a sample moves 146 chunks, not the 518 of a walk with every
//   slot in device memory, and sweeps the state 310 times, where one
//   sweep a gate took 607.
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
// The program's tables (passes, the staging plan at m = k, pass ops, the
// angle references at m > k) are copied into shared memory first where they
// fit beside
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
// (about 300 passes a sample, one sweep of 64 KB each but the data run's:
// tools/shift_dmem_trace.py times each kind of pass).
#include <cstdint>

#include "dmem.cuh"
#include "statevector.cuh"

namespace vqc {

constexpr int kWalkPassFields = 7;  // source, destination, row, op lo, op hi, local mask (two halves)
// a pass's staging plan at m = k: work region, fetch buffer and slot (loaded
// and waited for before the pass), wait buffer, read region, load buffer
// and slot (issued ahead, into a buffer the pass leaves alone), the pass's
// form and its orbit's bits; -1 for none
constexpr int kStageFields = 9;
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

// ------------------------------------------------- one-sweep passes (m = k)
//
// Every pass of the walk but the data run sweeps the state once.  A pass
// whose gates couple amplitudes across at most two element bits (amplitude
// bits from 2 up; bits 0-1 are a float4's own) takes kOrbitRun: a thread
// takes whole orbits of bits 0-1 and two element bits (16 amplitudes in
// registers), reads them a float4 at a time from the pass's read region,
// applies every gate of the pass in circuit order with chunk_gates'
// arithmetic (one_qubit, rot1, rot2) and writes them to its work region;
// the diagonal gates (RZ, RZZ, CRZ) and CRY's control need no orbit bit,
// an amplitude's own bits choosing its expression.  Every amplitude meets
// the same operations in the same order, so the bits are chunk_gates'.  A
// pass of one gate that ends in an inner product on a staged checkpoint
// (the variants and f0) writes nothing (kElementInner): each thread keeps
// chunk_inner's float4 elements t, t + 512, ..., reads the element (and the
// one its gate couples it to) from the checkpoint where it stands, computes
// its own amplitudes' results in registers and adds them to <chi|v> in
// chunk_inner's order: the same bits, no barrier between gate and sum, and
// the checkpoint left staged for the parameter's other shifts.  The host's
// staging plan names each pass's form and orbit (_pass_form: from its
// gates and whether it ends in an inner product).
enum : int { kPerGate = 0, kOrbitRun = 1, kElementInner = 2 };
constexpr int kOrbit = 16;  // amplitudes of an orbit: slot bits 0-1 a float4's, 2-3 its elements'

// Tests of an amplitude's bits a gate's expression depends on, made a
// float4 element at a time: an amplitude is lane l (bits 0-1) of element e,
// so each test is the element's share, from e, and the lane's, bit l of a
// word built once a gate.  odd: the bits at ``parity`` hold an odd count;
// set: the bit at ``role`` is set; on: every bit at ``control`` is set
// (control 0: always).
struct AmpTests {
  int parity, role, control;
  unsigned odd_l = 0, set_l = 0, on_l = 0;

  __device__ AmpTests(int parity_, int role_, int control_)
      : parity(parity_), role(role_), control(control_) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      odd_l |= static_cast<unsigned>(__popc(l & parity) & 1) << l;
      set_l |= static_cast<unsigned>((l & role) != 0) << l;
      on_l |= static_cast<unsigned>((l & control & 3) == (control & 3)) << l;
    }
  }
  // element e's shares (e4 = 4e): bit 0 odd, bit 1 set, bit 2 on
  __device__ unsigned element(int e4) const {
    return (__popc(e4 & parity) & 1) | ((e4 & role) != 0) << 1 |
           ((e4 & control) == (control & ~3)) << 2;
  }
  __device__ bool odd(unsigned el, int l) const { return (el ^ odd_l >> l) & 1u; }
  __device__ bool set(unsigned el, int l) const { return (el >> 1 | set_l >> l) & 1u; }
  __device__ bool on(unsigned el, int l) const { return (el >> 2 & on_l >> l) & 1u; }
};

// A diagonal gate (RZ, RZZ, CRZ) on an amplitude, as rot1 / rot2 apply it:
// dot2(c, r, s, m), dot2(c, m, -s, r), s = -sn where the amplitude's bits at
// the parity mask hold an odd count, else sn; the amplitude as it is where
// a control bit is clear.
__device__ __forceinline__ void phase_one(float c, float sn, bool odd, bool on, float& r,
                                          float& m) {
  const float s = odd ? -sn : sn;
  const float nr = dot2(c, r, s, m), nm = dot2(c, m, -s, r);
  if (on) r = nr, m = nm;
}

// The masks of a diagonal gate's expression: its parity (RZ: its qubit; RZZ:
// both; CRZ: the target) and control (CRZ's first qubit).
__device__ __forceinline__ AmpTests phase_tests(const int* op, int k) {
  const int g = op[0], ma = 1 << (k - 1 - op[1]), mb = g == kRZ ? 0 : 1 << (k - 1 - op[2]);
  return g == kCRZ ? AmpTests(mb, 0, ma) : AmpTests(ma | mb, 0, 0);
}

// The gate G (H, RX, RY; RYY on positions P + 1 and P; CRY's target at P)
// with its coupled qubit at orbit slot bit P; CRY's control tested by t on
// el[j], the shares of the orbit's element j.
template <int G, int P>
__device__ __forceinline__ void orbit_gate(float c, float sn, const AmpTests& t,
                                           const unsigned (&el)[4], float (&re)[kOrbit],
                                           float (&im)[kOrbit]) {
  if constexpr (G == kRYY) {
#pragma unroll
    for (int i = 0; i < kOrbit / 4; ++i) {
      const int x = ((i >> P) << (P + 2)) | (i & ((1 << P) - 1));
      const int i01 = x | (1 << P), i10 = x | (2 << P), i11 = x | (3 << P);
      rot2(G, c, sn, re[x], im[x], re[i01], im[i01], re[i10], im[i10], re[i11], im[i11]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kOrbit / 2; ++i) {
      const int i0 = ((i >> P) << (P + 1)) | (i & ((1 << P) - 1)), i1 = i0 | (1 << P);
      if constexpr (G == kCRY) {
        float r0 = re[i0], m0 = im[i0], r1 = re[i1], m1 = im[i1];
        rot1(G, c, sn, r0, m0, r1, m1);
        if (t.on(el[i0 >> 2], i0 & 3)) {
          re[i0] = r0, im[i0] = m0, re[i1] = r1, im[i1] = m1;
        }
      } else {
        one_qubit(G, c, sn, re[i0], im[i0], re[i1], im[i1]);
      }
    }
  }
}

template <int G>
__device__ __forceinline__ void orbit_gate_p(int p, float c, float sn, const AmpTests& t,
                                             const unsigned (&el)[4], float (&re)[kOrbit],
                                             float (&im)[kOrbit]) {
  switch (p) {
    case 0: orbit_gate<G, 0>(c, sn, t, el, re, im); break;
    case 1: orbit_gate<G, 1>(c, sn, t, el, re, im); break;
    case 2: orbit_gate<G, 2>(c, sn, t, el, re, im); break;
    default: if constexpr (G != kRYY) orbit_gate<G, 3>(c, sn, t, el, re, im); break;
  }
}

// Element slot j <-> slot j ^ f at each element position of ``swapped``
// (uniform) where this thread's f has it: a thread reads and writes its
// elements in the order j ^ f, so that each eight lanes of a warp meet the
// eight float4 bank groups, and the gates see the orbit in its own order.
__device__ __forceinline__ void orbit_swap(unsigned swapped, unsigned f, float (&re)[kOrbit],
                                           float (&im)[kOrbit]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (!(swapped >> p & 1u)) continue;
    const bool s = f >> p & 1u;
#pragma unroll
    for (int i = 0; i < kOrbit / 2; ++i) {
      const int j0 = ((i >> (p + 2)) << (p + 3)) | (i & ((4 << p) - 1)), j1 = j0 | (4 << p);
      const float a = re[j0], b = re[j1], x = im[j0], y = im[j1];
      re[j0] = s ? b : a;
      re[j1] = s ? a : b;
      im[j0] = s ? y : x;
      im[j1] = s ? x : y;
    }
  }
}

// A kOrbitRun pass: ops [0, n_ops) with their cos / sin (angles) on the
// state at float src of shared memory (-1: |0...0>) into the one at dst
// (src itself: in place).  ``orbit`` holds amplitude bits 0 and 1 and two
// element bits.  A warp's lanes take the orbits of the lowest element bits
// outside it; an orbit element bit below 3 (of those a float4 access's
// eight lanes must vary) is paired with one of the lanes' bits above, and a
// lane whose paired bit is set takes that element bit's two halves in the
// other order.
__device__ __noinline__ void orbit_run(const int* ops, const float* angles, int n_ops,
                                       unsigned orbit, int src, int dst, int k) {
  extern __shared__ __align__(16) float smem[];
  const int size = 1 << k;
  const unsigned eorbit = orbit >> 2;  // the element bits
  int bit[2], pair[2];
  unsigned swapped = 0;
  {
    unsigned o = eorbit;
    int h = 3;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      bit[p] = __ffs(o) - 1;
      o &= o - 1;
      pair[p] = -1;
      if (bit[p] >= 3) continue;
      while (h < k - 2 && (eorbit >> h & 1u)) ++h;
      if (h < k - 2) {
        pair[p] = h++;
        swapped |= 1u << p;
      }
    }
  }
  const int e0 = 1 << bit[0], e1 = 1 << bit[1];
#pragma unroll 1
  for (int o = threadIdx.x; o < size / kOrbit; o += blockDim.x) {
    const int base = insert0(insert0(o, bit[0]), bit[1]);  // o at the element bits outside it
    unsigned f = 0;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (pair[p] >= 0 && (base >> pair[p] & 1)) f |= 1u << p;
    }
    const int bx = base | (f & 1u ? e0 : 0) | (f & 2u ? e1 : 0);
    const int amp[4] = {base << 2, (base | e0) << 2, (base | e1) << 2, (base | e0 | e1) << 2};
    float re[kOrbit], im[kOrbit];
    if (src >= 0) {
      const float4* sre = reinterpret_cast<const float4*>(smem + src);
      const float4* sim = reinterpret_cast<const float4*>(smem + src + size);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = bx ^ (j & 1 ? e0 : 0) ^ (j & 2 ? e1 : 0);
        const float4 r = sre[e], m = sim[e];
        re[4 * j] = r.x, re[4 * j + 1] = r.y, re[4 * j + 2] = r.z, re[4 * j + 3] = r.w;
        im[4 * j] = m.x, im[4 * j + 1] = m.y, im[4 * j + 2] = m.z, im[4 * j + 3] = m.w;
      }
      orbit_swap(swapped, f, re, im);
    } else {
#pragma unroll
      for (int j = 0; j < kOrbit; ++j) {
        re[j] = base == 0 && j == 0 ? 1.f : 0.f;
        im[j] = 0.f;
      }
    }
#pragma unroll 1
    for (int i = 0; i < n_ops; ++i) {
      const int* op = ops + i * kOpFields;
      const int g = op[0];
      const float c = angles[2 * i], sn = angles[2 * i + 1];
      if (g == kRZ || g == kRZZ || g == kCRZ) {
        const AmpTests t = phase_tests(op, k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned el = t.element(amp[j]);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            phase_one(c, sn, t.odd(el, l), t.on(el, l), re[4 * j + l], im[4 * j + l]);
          }
        }
        continue;
      }
      // the coupled qubit's position (RYY: its second qubit's, the lower bit)
      const int p = __popc(orbit & ((1u << (k - 1 - op[g >= kRYY ? 2 : 1])) - 1));
      const AmpTests t(0, 0, g == kCRY ? 1 << (k - 1 - op[1]) : 0);
      unsigned el[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) el[j] = t.element(amp[j]);
      switch (g) {
        case kH: orbit_gate_p<kH>(p, c, sn, t, el, re, im); break;
        case kRX: orbit_gate_p<kRX>(p, c, sn, t, el, re, im); break;
        case kRY: orbit_gate_p<kRY>(p, c, sn, t, el, re, im); break;
        case kRYY: orbit_gate_p<kRYY>(p, c, sn, t, el, re, im); break;
        default: orbit_gate_p<kCRY>(p, c, sn, t, el, re, im); break;
      }
    }
    orbit_swap(swapped, f, re, im);
    float4* dre = reinterpret_cast<float4*>(smem + dst);
    float4* dim_ = reinterpret_cast<float4*>(smem + dst + size);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = bx ^ (j & 1 ? e0 : 0) ^ (j & 2 ? e1 : 0);
      dre[e] = make_float4(re[4 * j], re[4 * j + 1], re[4 * j + 2], re[4 * j + 3]);
      dim_[e] = make_float4(im[4 * j], im[4 * j + 1], im[4 * j + 2], im[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

// The kinds of the one gate of a kElementInner pass, by the expression an
// amplitude's result takes (rot1 / rot2 / one_qubit's, term for term), with
// its partner (r', m') the amplitude the gate mixes it with:
//   kPhase   RZ, RZZ, CRZ: phase_one;
//   kCross   RX, RYY: dot2(c, r, s, m'), dot2(c, m, -s, r'), s = sn where
//            its bits at the parity mask are odd or ``flip`` (RX), else -sn;
//   kRotY    RY, CRY: by its bit at the role mask dot2(c, r, -sn, r') or
//            dot2(sn, r', c, r) (m the same); as it is where a control bit
//            is clear;
//   kHad     H: (r + r') / sqrt 2 or (r' - r) / sqrt 2 by its role bit.
enum : int { kPhase, kCross, kRotY, kHad };

template <int K>
__device__ __forceinline__ void own_result(float c, float sn, bool flip, bool odd, bool set,
                                           bool on, float ro, float mo, float rp, float mp,
                                           float& vr, float& vi) {
  if constexpr (K == kPhase) {
    vr = ro, vi = mo;
    phase_one(c, sn, odd, on, vr, vi);
  } else if constexpr (K == kCross) {
    const float s = odd || flip ? sn : -sn;
    vr = dot2(c, ro, s, mp);
    vi = dot2(c, mo, -s, rp);
  } else if constexpr (K == kRotY) {
    const float x0 = set ? sn : c, x1 = set ? c : -sn;
    vr = dot2(x0, set ? rp : ro, x1, set ? ro : rp);
    vi = dot2(x0, set ? mp : mo, x1, set ? mo : mp);
    if (!on) vr = ro, vi = mo;
  } else {
    const float inv = 0.7071067811865476f;
    vr = ((set ? rp : ro) + (set ? -ro : rp)) * inv;
    vi = ((set ? mp : mo) + (set ? -mo : mp)) * inv;
  }
}

// A kElementInner pass: <chi|G s> for the one gate G with s at (sre, sim),
// chi at (cre, cim); the partner of an amplitude that amplitude with the
// bits of ``couple`` flipped (DLO of them the float4's own).
template <int K, int DLO>
__device__ __forceinline__ float2 element_inner_k(float c, float sn, bool flip, const AmpTests& t,
                                                  int couple, const float4* sre,
                                                  const float4* sim, const float4* cre,
                                                  const float4* cim, int n4, float* partial) {
  const int dhi = couple >> 2;
  float ip_re = 0.f, ip_im = 0.f;
#pragma unroll 2
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    const float4 r = sre[e], m = sim[e];
    float4 pr = r, pm = m;
    if (dhi) {
      pr = sre[e ^ dhi];
      pm = sim[e ^ dhi];
    }
    const float4 xr = cre[e], xi = cim[e];
    const unsigned el = t.element(e << 2);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      float vr, vi;
      // the role bit is the coupled one: an element bit where DLO is 0
      const bool set = DLO == 0 ? (el >> 1 & 1u) != 0 : t.set(el, l);
      own_result<K>(c, sn, flip, t.odd(el, l), set, t.on(el, l), lane(r, l), lane(m, l),
                    lane(pr, l ^ DLO), lane(pm, l ^ DLO), vr, vi);
      accumulate(lane(xr, l), lane(xi, l), vr, vi, ip_re, ip_im);
    }
  }
  return block_sum2(ip_re, ip_im, partial);
}

// element_inner: s at float src of shared memory, chi in region 0.
__device__ __noinline__ float2 element_inner(const int* op, float c, float sn, int src, int k,
                                             float* partial) {
  extern __shared__ __align__(16) float smem[];
  const int g = op[0], size = 1 << k, n4 = size / 4;
  const int ma = 1 << (k - 1 - op[1]), mb = g >= kRYY ? 1 << (k - 1 - op[2]) : 0;
  int kind, couple, parity = 0, role = 0, control = 0;
  if (g == kRZ || g == kRZZ || g == kCRZ) {
    kind = kPhase, couple = 0;
    parity = g == kCRZ ? mb : ma | mb;
    control = g == kCRZ ? ma : 0;
  } else if (g == kRX || g == kRYY) {
    kind = kCross, couple = ma | mb;
    parity = mb ? ma | mb : 0;
  } else if (g == kRY || g == kCRY) {
    kind = kRotY, couple = role = g == kCRY ? mb : ma;
    control = g == kCRY ? ma : 0;
  } else {
    kind = kHad, couple = role = ma;
  }
  const AmpTests t(parity, role, control);
  const bool flip = g == kRX;
  const float4 *sre = reinterpret_cast<const float4*>(smem + src), *sim = sre + n4;
  const float4 *cre = reinterpret_cast<const float4*>(smem), *cim = cre + n4;  // chi
#define VQC_ELEMENT(K, D) \
  element_inner_k<K, D>(c, sn, flip, t, couple, sre, sim, cre, cim, n4, partial)
  switch (kind * 4 + (couple & 3)) {
    case kPhase * 4: return VQC_ELEMENT(kPhase, 0);
    case kCross * 4: return VQC_ELEMENT(kCross, 0);
    case kCross * 4 + 1: return VQC_ELEMENT(kCross, 1);
    case kCross * 4 + 2: return VQC_ELEMENT(kCross, 2);
    case kCross * 4 + 3: return VQC_ELEMENT(kCross, 3);
    case kRotY * 4: return VQC_ELEMENT(kRotY, 0);
    case kRotY * 4 + 1: return VQC_ELEMENT(kRotY, 1);
    case kRotY * 4 + 2: return VQC_ELEMENT(kRotY, 2);
    case kHad * 4: return VQC_ELEMENT(kHad, 0);
    case kHad * 4 + 1: return VQC_ELEMENT(kHad, 1);
    default: return VQC_ELEMENT(kHad, 2);
  }
#undef VQC_ELEMENT
}

// The walk at m > k, chunk by chunk.  Resident (m = k + 1): chi whole in
// regions 0-1, each chunk in region 2.  Streamed: chunk c in region
// 1 + (c & 1), chi's chunk for an inner product in region 0.  The sample's
// scratch slots at mine (slot s at mine + s * 2 * 2^m), its rows in column
// col of out; ang, pang, the deposit tables and the partial sums in shared
// memory as the kernel laid them out.
__device__ __noinline__ void chunked_walk(const float* th, const float* dt, const int* base_ops,
                                          const float* base_consts, int n_base,
                                          const int* var_param, const float* var_shift, int n_var,
                                          const int* passes, int n_passes, const int* pass_ops,
                                          const int* pass_refs, const int* f0_rows, int n_f0_rows,
                                          int m, int k, float* mine, float* out,
                                          long long out_stride, long long col, float* ang,
                                          float* pang, long long* dep_lo, long long* dep_hi,
                                          float* partial) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, size = 1 << k;
  const long long dim = 1LL << m;
  auto region = [&](int i) { return smem + 2 * size * i; };
  for (int j = tid; j < n_base; j += blockDim.x) {
    op_angle(base_ops + j * kOpFields, base_consts[j], th, dt, 0.f, ang[2 * j], ang[2 * j + 1]);
  }
  for (int v = tid; v < n_var; v += blockDim.x) {
    const float a = th[var_param[v]] + var_shift[v];
    ang[2 * (n_base + v)] = cosf(a / 2.f);
    ang[2 * (n_base + v) + 1] = sinf(a / 2.f);
  }
  __syncthreads();  // the tables copied: each pass reads its rows before its first barrier
  const unsigned long long all = (1ULL << m) - 1;
  const long long n_chunks = 1LL << (m - k);
  const bool resident = m == k + 1;
  float4* rre = reinterpret_cast<float4*>(smem);  // resident chi: re [2^m], then im
  float4* rim = rre + dim / 4;
  unsigned long long staged_mask = 0;  // the local mask the deposit tables hold (0: none)
#pragma unroll 1
  for (int p = 0; p < n_passes; ++p) {
    const int* row = passes + p * kWalkPassFields;
    const int src = row[0], dst = row[1], out_row = row[2], lo = row[3], n_ops = row[4] - lo;
    const int* ops = pass_ops + lo * kOpFields;
    const unsigned long long local = mask_at(row + 5);
    __syncthreads();  // the last pass is done with pang and the deposit tables
    if (local != staged_mask) {
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
    __syncthreads();  // pang and the deposit tables
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
                 col);
    }
  }
}

// Sample blockIdx.x of the launch: its angles at theta + b * n_theta, its
// scratch at scratch + b * sample_floats (the slots from the first one kept
// in device memory: 2 at m = k, 1 at m = k + 1, else 0), its rows in column
// col0 + b of out (out_stride columns).  stage: the staging plan (m = k;
// null where m > k).  tables_in_smem: the program's tables (passes, stage
// where there is one, pass_ops, and pass_refs where m > k) are copied into
// shared memory first, where the host found room for them, so that no pass
// waits on device memory for its own description.
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
  const int n_ops_total = passes[(n_passes - 1) * kWalkPassFields + 4];
  // three regions of one chunk's (re, im), then the tables: at m = k each
  // pass op's cos / sin (built once), else the deposit tables, the angle
  // table and a pass's cos / sin
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 6 * size);  // [2]: buffers 1 and 2 (m = k)
  float* partial = reinterpret_cast<float*>(bar + 2);              // two a warp
  long long* dep_lo = reinterpret_cast<long long*>(partial + 64);
  long long* dep_hi = dep_lo + kDepLo;
  float* ang = m == k ? partial + 64 : reinterpret_cast<float*>(dep_hi + kDepHi);
  float* pang = ang + 2 * (m == k ? n_ops_total : n_base + n_var);  // [2 * max_pass_ops] (m > k)
  if (tables_in_smem) {  // passes, stage (m = k), pass_ops, pass_refs (m > k)
    const int np = n_passes * kWalkPassFields, no = n_ops_total * kOpFields;
    const int ns = m == k ? n_passes * kStageFields : 0, nt = np + ns;
    const int nr = m == k ? 0 : n_ops_total;
    int* t = reinterpret_cast<int*>(m == k ? pang : pang + 2 * max_pass_ops);
    for (int e = tid; e < nt + no + nr; e += blockDim.x) {
      t[e] = e < np ? passes[e] : e < nt ? stage[e - np] : e < nt + no
             ? pass_ops[e - nt] : pass_refs[e - nt - no];
    }
    passes = t;
    if (ns) stage = t + np;
    pass_ops = t + nt;
    if (nr) pass_refs = t + nt + no;
  }
  auto region = [&](int i) { return smem + 2 * size * i; };

  if (m == k) {
    if (tid == 0) {
      for (int i = 0; i < 2; ++i) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar + i)), "r"(1)
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int j = tid; j < n_ops_total; j += blockDim.x) {  // op_angle's, then the variants'
      const int ref = pass_refs[j], a = ref >> 1;
      float c, sn;
      if (a < n_base) {
        op_angle(base_ops + a * kOpFields, base_consts[a], th, dt, 0.f, c, sn);
      } else {
        const float x = th[var_param[a - n_base]] + var_shift[a - n_base];
        c = cosf(x / 2.f);
        sn = sinf(x / 2.f);
      }
      ang[2 * j] = c;
      ang[2 * j + 1] = (ref & 1) ? -sn : sn;
    }
    __syncthreads();  // the tables copied and the angles built
    unsigned phase = 0;         // bit i: parity of buffer i's next load
    int recent = -1;            // the buffer the latest bulk store may still read
    unsigned older = 0;         // bit i: an earlier bulk store may still read buffer i
    bool stores_open = false;   // a bulk store not yet known written
#pragma unroll 1
    for (int p = 0; p < n_passes; ++p) {
      const int* row = passes + p * kWalkPassFields;
      const int* st = stage + p * kStageFields;
      const int work = st[0], wait = st[3], rd = st[4], load = st[5], form = st[7];
      if (recent >= 0 || older) {  // no buffer is written while a store reads it
        const unsigned writes = (work > 0 ? 1u << work : 0u) | (st[1] >= 0 ? 1u << st[1] : 0u) |
                                (load >= 0 ? 1u << load : 0u);
        if (recent >= 0 && (writes >> recent & 1u)) {
          if (tid == 0) bulk_wait_read();
          recent = -1;
          older = 0;
        } else if (writes & older) {
          if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          older = 0;
        }
      }
      const int dst = row[1], out_row = row[2], lo = row[3], n_ops = row[4] - lo;
      const int* ops = pass_ops + lo * kOpFields;
      const float* pang_p = ang + 2 * lo;
      __syncthreads();  // the last pass is done with the regions and the partial sums
      if (st[1] >= 0) {  // fetch this pass's checkpoint
        if (tid == 0) {
          if (stores_open) bulk_wait_written();
          bulk_load_state(region(st[1]), mine + st[2] * 2 * dim, size, smem_u32(bar + st[1] - 1));
        }
        if (stores_open) recent = -1, older = 0, stores_open = false;
      }
      if (wait >= 0) {
        mbar_wait(smem_u32(bar + wait - 1), (phase >> wait) & 1u);
        phase ^= 1u << wait;
      }
      if (load >= 0) {  // the next checkpoint, ahead, into a region this pass leaves alone
        if (tid == 0) {
          if (stores_open) bulk_wait_written();
          bulk_load_state(region(load), mine + st[6] * 2 * dim, size, smem_u32(bar + load - 1));
        }
        if (stores_open) recent = -1, older = 0, stores_open = false;
      }
      const float* r = rd >= 0 ? region(rd) : nullptr;
      if (form == kElementInner) {
        const float2 ip = element_inner(ops, pang_p[0], pang_p[1], 2 * size * rd, k, partial);
        if (tid == 0) {
          write_rows(ip.x * ip.x + ip.y * ip.y, out_row, f0_rows, n_f0_rows, out, out_stride,
                     col0 + b);
        }
        continue;
      }
      float* w = region(work);
      if (form == kOrbitRun) {
        orbit_run(ops, pang_p, n_ops, static_cast<unsigned>(st[8]), rd >= 0 ? 2 * size * rd : -1,
                  2 * size * work, k);
      } else {
        if (r != w) {  // |0...0> or a copy into the work region
          make_state(reinterpret_cast<float4*>(w), reinterpret_cast<float4*>(w + size),
                     reinterpret_cast<const float4*>(r),
                     reinterpret_cast<const float4*>(r ? r + size : nullptr), size / 4);
          __syncthreads();
        }
        chunk_gates(ops, pang_p, 0, n_ops, w, w + size, k);
      }
      if (dst > 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) bulk_store_state(mine + dst * 2 * dim, w, size);
        if (recent >= 0) older |= 1u << recent;
        recent = work;
        stores_open = true;
      }
      if (out_row != -1) {
        if (form == kOrbitRun) __syncthreads();  // every orbit written
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
    }
    if (tid == 0) bulk_wait_written();  // no store outlives the block
    return;
  }

  chunked_walk(th, dt, base_ops, base_consts, n_base, var_param, var_shift, n_var, passes,
               n_passes, pass_ops, pass_refs, f0_rows, n_f0_rows, m, k, mine, out, out_stride,
               col0 + b, ang, pang, dep_lo, dep_hi, partial);
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
