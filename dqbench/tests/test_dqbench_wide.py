"""The 27q cell's yardstick on the CPU: the wide route's least work, and the
readers of its three per-layer metrics on made-up traces."""
import pytest

import counters
import dense_wide_counters
import harness
import program_trace
import tracing

CELL = "train.27q3l.b64"


def _ctx(trace=None, program=None):
    cell = harness.load_cell(CELL)
    ctx = harness.Context(cell, cell.model, 1.0, 10, 0.12, [0.012] * 10, 0.0, trace)
    if program is not None:
        ctx.program = program
    return ctx


def test_wide_bound_counts_one_inner_product_a_class_and_patch():
    model = harness.load_cell(CELL).model
    samples = 64 * model.n_patches
    psi_gates = 26 * 6 + 24 * 6 + 24 * 3       # RY, RZ; RYY, RZZ; CRY, CRZ at m = 13
    assert dense_wide_counters.flops(model, samples) == 2 * (576 * 8 + psi_gates) * 2**13
    assert dense_wide_counters.flops(model, samples) == 81_592_320
    assert dense_wide_counters.nbytes(model, samples) == 4 * (576 * 16 + 2 * (16 * 26 + 26))
    assert dense_wide_counters.bound_s(model, samples) == pytest.approx(1.2178e-6, rel=1e-4)
    assert dense_wide_counters.flops(model, samples) < counters.dense_flops(model, samples)


def _op(name, dur):
    return tracing.DeviceOp(name, 0.0, dur, "executor")


def test_roofline_readers_sum_their_kernels_over_the_traced_steps():
    ops = [_op("void vqc::dense_wide_kernel<13>(float const*, int)", 60e-6),
           _op("vqc::dense_wide_psi_kernel(float const*, int)", 90e-6),
           _op("vqc::dense_reduce_kernel(float const*, int, int, float*)", 6e-6),
           _op("vqc::shift_dmem_kernel(float const*, float const*)", 4.8e-3),
           _op("vqc::shift_dmem_kernel(float const*, float const*)", 4.8e-3)]
    ctx = _ctx(tracing.Trace(ops, (0.0, 0.012), 1, 0.0, []))
    model = ctx.model
    wide = harness.load_reader("dense_wide_roofline")(ctx)
    assert wide == pytest.approx(100 * dense_wide_counters.bound_s(model, 576) / 150e-6)
    dmem = harness.load_reader("shift_dmem_roofline")(ctx)
    assert dmem == pytest.approx(100 * counters.bank_bound_s(model, 576, 2) / 9.6e-3)
    assert 0 < wide < 100 and 0 < dmem < 100
    empty = _ctx(tracing.Trace([_op("vqc::shiftbank_kernel", 1e-3)], (0.0, 1.0), 1, 0.0, []))
    for name in ("dense_wide_roofline", "shift_dmem_roofline"):
        assert harness.load_reader(name)(empty) is None
        assert harness.load_reader(name)(_ctx()) is None


def test_dense_wide_device_ms_reads_the_dense_span():
    read = harness.load_reader("dense_wide_device_ms.train")
    device = {"grad_shift.dense.forward": [1.6e-3, 130], "grad_shift.dense.backward": [6e-5, 10],
              "dataplane.worker": [0.096, 80]}
    got = program_trace.Reading(40, {}, program_trace.ProgramTrace(10, 10, device, []))
    assert read(_ctx(program=got)) == pytest.approx(0.166)
    none = program_trace.Reading(40, {}, program_trace.ProgramTrace(10, 10, {}, []))
    assert read(_ctx(program=none)) is None
