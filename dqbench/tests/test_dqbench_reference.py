"""The plain reference on the CPU: its factored fidelity against its own
whole-circuit SWAP test, and one training step against the program's at a
tiny size (rows of the bank, gradients, updated parameters)."""
import math

import numpy as np
import pytest
import torch

import digits
import ref_quclassi as R

F64 = R.Precision(torch.float64)
SHAPES = [(5, 1), (7, 3)]


def model(qc, nl, dense=True):
    return R.Model(qc, nl, 2, 4, 2, (8, 8), dense)


@pytest.mark.parametrize("qc,nl", SHAPES + [(7, 2)])
def test_register_fidelity_is_the_swap_test(qc, nl):
    m = model(qc, nl)
    g = torch.Generator().manual_seed(qc * 10 + nl)
    theta = torch.rand((6, m.n_theta), generator=g, dtype=torch.float64) * 2 * math.pi
    angles = torch.rand((6, m.n_angles), generator=g, dtype=torch.float64) * math.pi
    phi = R.run_ops(m.data_ops, m.m, angles, F64)
    psi = R.run_ops(m.train_ops, m.m, theta, F64)
    factored = R.register_fidelity(phi, psi, F64).diagonal()
    whole = R.swap_test_fidelity(m, theta, angles, F64)
    assert torch.allclose(factored, whole, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10_000, dtype=torch.float32)
    r = R.Precision(torch.float32, tf32=True).rnd(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()
    assert R.Precision().rnd(x) is x


def test_digits_are_made_from_the_seed():
    a = digits.make_pairs(1, 5, 64, seed=2**31 + 3)
    b = digits.make_pairs(1, 5, 64, seed=2**31 + 3)
    c = digits.make_pairs(1, 5, 64, seed=2**31 + 4)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[1].sum() == 32 and a[0].shape == (64, 8, 8)
    x = digits.clean(a[0])
    assert 0.0 <= x.min() and x.max() <= 1.0


@pytest.mark.parametrize("qc,nl", SHAPES)
def test_reference_step_against_the_program(qc, nl):
    from repro_torch.core import encoding, quclassi, segmentation, shift_rule
    from repro_torch.optim import optimizers

    m = model(qc, nl)
    cfg = quclassi.QuClassiConfig(qc=qc, n_layers=nl, image_size=(8, 8),
                                  seg=segmentation.SegmentationConfig(4, 2, 4))
    x, y = digits.make_pairs(1, 5, 2, seed=qc)
    images, labels = torch.as_tensor(digits.clean(x)), torch.as_tensor(y)
    params = quclassi.init_params(cfg, torch.Generator().manual_seed(nl), "cpu")

    # segmentation and the encoding without the dense layer
    assert torch.equal(R.segment(images, 4, 2), segmentation.segment(images, cfg.seg))
    patches = R.segment(images, 4, 2)
    for n in (6, 26, 5):
        assert torch.allclose(R.rotation_angles(patches, n),
                              encoding.rotation_angles(patches, n), atol=1e-6)

    # the bank's rows: base, +pi/2 and -pi/2 a parameter
    banks, angles = quclassi.build_class_banks(cfg, params, images, implicit=True)
    phi = R.run_ops(m.data_ops, m.m, angles.double(), F64)
    for c, bank in enumerate(banks):
        rows = shift_rule.run_bank(shift_rule.default_executor(cfg.spec), bank)
        psi = R.run_ops(m.train_ops, m.m, R.shifted(params["theta"][c].double()), F64)
        want = R.register_fidelity(phi, psi, F64).T.reshape(-1)
        assert torch.allclose(rows.double(), want, atol=2e-6)

    # gradients, loss and the updated parameters
    loss, grads, _ = quclassi.grad_shift(cfg, params, images, labels)
    rloss, rgrads = R.gradient(m, params, images, labels, F64)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    for k in grads:
        assert torch.allclose(grads[k].double(), rgrads[k], rtol=1e-4, atol=1e-6), k
    opt = optimizers.make("sgd", 1e-3)
    upd, _ = opt.update(grads, opt.init(params), params)
    new = optimizers.apply_updates(params, upd)
    rnew = R.sgd({k: v.double() for k, v in params.items()}, rgrads, 1e-3)
    for k in new:
        assert torch.allclose(new[k].double(), rnew[k], atol=1e-6), k
