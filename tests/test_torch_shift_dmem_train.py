"""One gradient step of 27-qubit QuClassi (m = 13) with implicit banks on
the CPU: the port (the shift walk's device-memory route, plain version)
against the reference (its spill pair in interpret mode), through a
1-worker implicit executor.

Fidelity rows agree to 1e-5 and to 1e-4 of their own size (rows of 5e-7
here).  Gradients carry the BCE chain factor 1/(f(1-f)) (ROADMAP Queue 3,
R2), so their tolerance is 1e-5 scaled by the largest chain factor of the
step; that factor reaches 1e7 here, where a fidelity is clamped, which
puts the tolerance far above the gradients, so they are also held to 1e-4
of the largest gradient.  One image a class and one 8 x 8 patch an
image keep each class's bank at B = 2 (the reference's ~8 s a bank).  The
patches encode without the dense layer (``use_dense=False``): the reference
takes the dense layer's gradient by autodiff through its dense simulator, a
2**27-amplitude state a sample at this width.  The port's dense gradient at
this width, the wide route on the registers, is held against the
benchmark's plain reference in ``test_torch_dense_wide.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api.capabilities import declare as jdeclare
from repro.comanager import dataplane as jdp
from repro.core import quclassi as jq
from repro.core import segmentation as jseg
from repro.data import mnist as jmnist
from repro_torch.api.capabilities import declare as tdeclare
from repro_torch.comanager import dataplane as tdp
from repro_torch.core import fidelity as tfid
from repro_torch.core import quclassi as tq
from repro_torch.core import segmentation as tseg
from repro_torch.kernels import ops as tops

ATOL = 1e-5
#: rows within ROW_RTOL of their own size (ROW_ATOL where ~0); gradients
#: within GRAD_RTOL of the largest
ROW_RTOL, ROW_ATOL, GRAD_RTOL = 1e-4, 1e-10, 1e-4


def _recording(run, declare, seen):
    def rec(*args):
        out = run(*args)
        seen.append(np.asarray(out))
        return out
    return declare(rec, shiftbank=True)


def test_27q_grad_shift_step_matches_reference():
    seg = dict(filter_width=8, stride=8, n_filters=4)
    jcfg = jq.QuClassiConfig(qc=27, n_layers=1, seg=jseg.SegmentationConfig(**seg),
                             use_dense=False)
    tcfg = tq.QuClassiConfig(qc=27, n_layers=1, seg=tseg.SegmentationConfig(**seg),
                             use_dense=False)
    assert tcfg.n_patches == 1
    x, y = jmnist.make_pair_dataset(1, 5, n_per_class=1, seed=0)
    n_groups = 1 + 2 * tcfg.n_theta
    assignment = tdp.round_robin_assignment(n_groups, 1)
    init = {k: np.asarray(v) for k, v in jq.init_params(jcfg, jax.random.PRNGKey(0)).items()}

    jrows, trows, infos = [], [], []
    jrun = _recording(jdp.worker_batched_executor(jcfg.spec, assignment, 1), jdeclare, jrows)
    trun = _recording(tdp.worker_batched_executor(tcfg.spec, assignment, 1), tdeclare, trows)
    jloss, jgrads, jf = jq.grad_shift(jcfg, {k: jnp.asarray(v) for k, v in init.items()},
                                      jnp.asarray(x), jnp.asarray(y), executor=jrun,
                                      implicit=True)
    prev = tops.set_launch_observer(infos.append)
    try:
        tloss, tgrads, tf = tq.grad_shift(tcfg, tq.params_from_numpy(init, "cpu"),
                                          torch.as_tensor(x), torch.as_tensor(y),
                                          executor=trun, implicit=True)
    finally:
        tops.set_launch_observer(prev)
    assert [(i["mode"], i["route"]) for i in infos] == [("spill", "dmem")] * tcfg.n_classes
    assert len(trows) == len(jrows) == tcfg.n_classes
    for t, j in zip(trows, jrows):
        assert t.shape == j.shape == (n_groups * 2,)
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
        np.testing.assert_allclose(t, j, rtol=ROW_RTOL, atol=ROW_ATOL, equal_nan=False)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=ROW_RTOL, atol=ROW_ATOL)
    onehot = np.eye(tcfg.n_classes, dtype=np.float32)[y]
    chain = tfid.bce_grad_wrt_fidelity(torch.from_numpy(np.asarray(jf)), torch.from_numpy(onehot))
    tol = ATOL * max(1.0, float(chain.abs().max()))
    assert abs(float(tloss) - float(jloss)) <= tol
    assert set(tgrads) == set(jgrads) == {"theta"}
    jg = np.asarray(jgrads["theta"])
    np.testing.assert_allclose(tgrads["theta"].numpy(), jg, rtol=0, atol=tol)
    np.testing.assert_allclose(tgrads["theta"].numpy(), jg, rtol=0,
                               atol=GRAD_RTOL * float(np.abs(jg).max()))
