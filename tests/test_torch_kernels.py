"""Port parity for the fused statevector kernels (fidelity and state).

The same numpy inputs, made from a seed, go through ``repro.kernels.ops``
(the Pallas kernels, in interpret mode on the CPU) and
``repro_torch.kernels.ops`` (on the CPU: the plain PyTorch version of each
CUDA kernel).  Tolerance 1e-5 absolute: both are float32 simulations of the
same circuit whose rounding differs (other cos/sin implementations, other
summation order), and 1e-5 is the reference's own kernel tolerance
(``tests/test_kernels.py``).  The port's own dense oracle (``ref.py``) is
checked at the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import circuits as jcircuits
from repro.kernels import ops as jops
from repro_torch.core import circuits as tcircuits
from repro_torch.core.sim import CircuitSpec, Op
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vqc_statevector as K

ATOL = 1e-5


def _specs(qc, nl, tied=False):
    name = "build_tied_quclassi_circuit" if tied else "build_quclassi_circuit"
    return getattr(jcircuits, name)(qc, nl), getattr(tcircuits, name)(qc, nl)


def _angles(spec, batch, seed):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-np.pi, np.pi, (batch, spec.n_theta)).astype(np.float32)
    data = rng.uniform(0.0, np.pi, (batch, spec.n_data)).astype(np.float32)
    return theta, data


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


def test_specs_equal_field_by_field():
    for tied in (False, True):
        js, ts = _specs(7, 3, tied)
        assert (ts.n_qubits, ts.n_theta, ts.n_data) == (js.n_qubits, js.n_theta, js.n_data)
        assert [(o.gate, o.qubits, o.param) for o in ts.ops] == [
            (o.gate, o.qubits, o.param) for o in js.ops
        ]


@pytest.mark.parametrize(
    "qc,nl,batch,tied",
    [(3, 1, 1, False), (3, 3, 7, False), (5, 2, 33, False), (5, 3, 1, False),
     (7, 3, 7, False), (7, 3, 33, True)],
)
def test_fidelity_and_state_match_reference(qc, nl, batch, tied):
    js, ts = _specs(qc, nl, tied)
    theta, data = _angles(ts, batch, seed=qc * 10 + nl)
    jt, jd = jnp.asarray(theta), jnp.asarray(data)
    tt, td = torch.from_numpy(theta), torch.from_numpy(data)

    got = tops.vqc_fidelity(ts, tt, td)
    assert got.shape == (batch,) and got.dtype == torch.float32
    _close(got, jops.vqc_fidelity(js, jt, jd))
    _close(got, tref.vqc_fidelity_ref(ts, tt, td))

    re, im = tops.vqc_state(ts, tt, td)
    jre, jim = jops.vqc_state(js, jt, jd)
    assert re.shape == (batch, 2**qc)
    _close(re, jre)
    _close(im, jim)
    rre, rim = tref.vqc_state_ref(ts, tt, td)
    _close(re, rre)
    _close(im, rim)


def test_p0_matches_reference():
    js, ts = _specs(5, 2)
    theta, data = _angles(ts, 6, seed=2)
    _close(tops.vqc_p0(ts, torch.from_numpy(theta), torch.from_numpy(data)),
           jops.vqc_p0(js, jnp.asarray(theta), jnp.asarray(data)))


def test_wide_p0_matches_reference():
    """From 15 qubits the plain P0 (the device-memory route's plain version)
    sums in float64: it is held to the reference's P0 at 1e-5, and to a
    float64 sum of its own state's probabilities far inside that."""
    js, ts = _specs(15, 1)
    theta, data = _angles(ts, 3, seed=15)
    tt, td = torch.from_numpy(theta), torch.from_numpy(data)
    got = tops.vqc_p0(ts, tt, td)
    _close(got, jops.vqc_p0(js, jnp.asarray(theta), jnp.asarray(data)))
    re, im = tops.vqc_state(ts, tt, td)
    half = 2 ** (ts.n_qubits - 1)
    exact = (re[:, :half].double() ** 2 + im[:, :half].double() ** 2).sum(1)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0, atol=1e-7)
    assert torch.equal(tops.vqc_p0(ts, tt[1:2], td[1:2]), got[1:2])


def test_state_norm_preserved_and_float64_downcast():
    _, ts = _specs(7, 3)
    theta, data = _angles(ts, 3, seed=4)
    re, im = tops.vqc_state(ts, torch.from_numpy(theta).double(), torch.from_numpy(data))
    assert re.dtype == torch.float32
    np.testing.assert_allclose((re**2 + im**2).sum(-1).numpy(), 1.0, atol=1e-5)


def test_lane_independence_bitwise():
    """A circuit's result never depends on the batch around it."""
    _, ts = _specs(5, 3)
    theta, data = _angles(ts, 40, seed=5)
    full = tops.vqc_fidelity(ts, torch.from_numpy(theta), torch.from_numpy(data))
    part = tops.vqc_fidelity(ts, torch.from_numpy(theta[9:12]), torch.from_numpy(data[9:12]))
    assert torch.equal(full[9:12], part)


def test_rejected_gates_raise_before_launch():
    x_spec = CircuitSpec(2, (Op("x", (0,)), Op("ry", (1,), ("theta", 0))), 1, 0)
    desc_cry = CircuitSpec(2, (Op("cry", (1, 0), ("theta", 0)),), 1, 0)
    t, d = torch.zeros((2, 1)), torch.zeros((2, 0))
    for spec in (x_spec, desc_cry):
        with pytest.raises(NotImplementedError):
            tops.vqc_fidelity(spec, t, d)
    # descending ryy/rzz are symmetric: swapped to ascending, same result
    asc = CircuitSpec(2, (Op("ry", (0,), ("theta", 0)), Op("ryy", (0, 1), ("theta", 0))), 1, 0)
    desc = CircuitSpec(2, (Op("ry", (0,), ("theta", 0)), Op("ryy", (1, 0), ("theta", 0))), 1, 0)
    t = torch.tensor([[0.3], [1.7]])
    assert torch.equal(tops.vqc_state(asc, t, d)[0], tops.vqc_state(desc, t, d)[0])
    _close(tops.vqc_state(desc, t, d)[1], tref.vqc_state_ref(desc, t, d)[1])


def test_cpu_path_counts_no_launches_and_bad_input_raises():
    _, ts = _specs(5, 1)
    theta, data = _angles(ts, 4, seed=6)
    before = dict(K.LAUNCHES)
    tops.vqc_fidelity(ts, torch.from_numpy(theta), torch.from_numpy(data))
    assert K.LAUNCHES == before
    with pytest.raises(ValueError):
        tops.vqc_fidelity(ts, torch.from_numpy(theta)[:, :2], torch.from_numpy(data))
    with pytest.raises(ValueError):
        tops.vqc_fidelity(ts, torch.from_numpy(theta), torch.from_numpy(data)[:3])
    with pytest.raises(ValueError):
        tops.vqc_fidelity(ts, torch.from_numpy(theta).to("meta"), torch.from_numpy(data).to("meta"))


def test_kernel_executor_matches_dense_oracle():
    _, ts = _specs(5, 1)
    theta, data = _angles(ts, 9, seed=7)
    run = tops.kernel_executor(ts)
    tt, td = torch.from_numpy(theta), torch.from_numpy(data)
    _close(run(tt, td), tref.vqc_fidelity_ref(ts, tt, td))

