"""The port's LM training path (``Model.loss``, ``launch/steps``'s train
step, ``optim/schedules``, ``synthetic_tokens``, ``launch/train``) against
the reference on the CPU.

Both packages get the same inputs: batches from the same numpy seeding
(``batch_for``), and the reference's parameters (``jax.random`` streams
cannot be reproduced in torch) carried across with ``params_from_numpy``.
Every ``reduced()`` config is float32.  Tolerances, the same for all ten
architectures:
  * loss: 1e-5 relative (float32 through 2 layers, other summation
    orders; the largest seen is 1.5e-7);
  * gradients: 1e-4 of the leaf's largest |gradient|, leaf by leaf (the
    largest seen is 2.5e-5, Jamba's Mamba ``dt_bias``);
  * parameters after one step: 1e-5.  For AdamW only where the
    reference's gradient exceeds 1e-3 of its leaf's largest: a first Adam
    step is ``lr * g / (|g| + eps)``, +-lr by the gradient's sign, so a
    near-zero gradient flips the update on a rounding (ROADMAP Queue 3
    R7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rcheckpoint
from repro.configs import base as rbase
from repro.data import pipeline as rpipeline
from repro.launch import steps as rsteps
from repro.models import transformer as rtransformer
from repro.optim import optimizers as roptimizers
from repro.optim import schedules as rschedules
from repro_torch.configs import base
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.models import moe, multimodal, transformer
from repro_torch.optim import optimizers, schedules

ALL_ARCHS = [
    "nemotron-4-340b", "phi-3-vision-4.2b", "granite-34b", "smollm-360m",
    "qwen3-4b", "granite-moe-3b-a800m", "musicgen-large", "xlstm-125m",
    "jamba-v0.1-52b", "deepseek-v3-671b",
]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_ATOL = 1e-5
#: R7: AdamW leaves are compared where |g_ref| > ADAM_MASK * max |g_ref|
ADAM_MASK = 1e-3
SEQ = 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _jax(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _port(cfg, tree):
    model = transformer.Model(cfg, device="cpu")
    model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    return model


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float32))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


class _Ref:
    """Per architecture, computed once a session: both packages' reduced
    configs, the reference's parameters (jax and numpy) and its jitted
    ``value_and_grad`` of ``Model.loss``."""

    def __init__(self):
        self._cache = {}

    def __call__(self, arch):
        if arch not in self._cache:
            rcfg = rbase.get(arch).reduced()
            rmodel = rtransformer.Model(rcfg)
            params = rmodel.init_params(jax.random.PRNGKey(0))
            self._cache[arch] = dict(
                rcfg=rcfg, cfg=base.get(arch).reduced(), params=params,
                tree=jax.tree.map(np.asarray, params),
                vg=jax.jit(jax.value_and_grad(rmodel.loss)))
        return self._cache[arch]


@pytest.fixture(scope="session")
def ref():
    return _Ref()


@pytest.fixture(scope="session")
def grads(ref):
    """Per architecture: the loss and gradients of both packages on one
    batch of 2 x 16."""
    out = {}

    def get(arch):
        if arch not in out:
            r = ref(arch)
            batch = multimodal.batch_for(r["cfg"], 2, SEQ, seed=0)
            rloss, rgrad = r["vg"](r["params"], _jax(batch))
            model = _port(r["cfg"], r["tree"])
            loss = model.loss(batch)
            loss.backward()
            out[arch] = (float(rloss), rgrad, loss.detach(),
                         transformer.grads_to_numpy(r["cfg"], model))
        return out[arch]

    return get


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_matches_reference(arch, grads):
    rloss, _, loss, _ = grads(arch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), rloss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_gradients_match_reference(arch, grads):
    """Every leaf against ``jax.grad(model.loss)``, within GRAD_TOL of the
    leaf's largest |gradient|; the trees have the same structure."""
    _, rgrad, _, got = grads(arch)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, rgrad))
    for (path, want), (_, have) in zip(_leaves(rgrad), _leaves(got)):
        assert have.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(have - want).max())
        assert err <= GRAD_TOL * scale, (arch, path, err, scale)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_matches_reference(arch, ref):
    """One step of global batch 4: two interleaved microbatches of the
    reduced ``microbatch`` = 2.  The loss within LOSS_RTOL; the new
    parameters within PARAM_ATOL (AdamW: under the R7 mask, from the
    reference's averaged gradients, which clipping only scales)."""
    r = ref(arch)
    cfg, rcfg = r["cfg"], r["rcfg"]
    batch = multimodal.batch_for(cfg, 4, SEQ, seed=1)
    rstep, roptimizer, _ = rsteps.make_train_step(rcfg, global_batch=4)
    new_params, _, rloss = jax.jit(rstep)(r["params"], roptimizer.init(r["params"]),
                                          _jax(batch))
    micro = [r["vg"](r["params"], mb)[1] for mb in
             (jax.tree.map(lambda a, i=i: a[i], rsteps._micro_split(_jax(batch), 2))
              for i in range(2))]
    rgrad = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2, *micro)

    train_step, optimizer, model = steps.make_train_step(
        cfg, global_batch=4, model=_port(cfg, r["tree"]))
    stats = {}
    _, loss = train_step(optimizer.init(dict(model.named_parameters())), batch, stats)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)
    assert torch.isfinite(stats["grad_norm"])
    got = transformer.params_to_numpy(cfg, model)
    adam = cfg.optimizer in ("adam", "adamw")
    for (path, want), (_, have), (_, g) in zip(_leaves(new_params), _leaves(got),
                                                _leaves(rgrad)):
        mask = (np.abs(g) > ADAM_MASK * np.abs(g).max()) if adam else np.ones(g.shape, bool)
        err = float(np.abs(have - want)[mask].max(initial=0.0))
        assert err <= PARAM_ATOL, (arch, path, err)


def test_microbatch_rows_interleave_as_reference():
    """``micro_split`` equals the reference's ``_micro_split`` row for row,
    for every key of a VLM batch; a batch the count does not divide
    raises."""
    cfg = base.get("phi-3-vision-4.2b").reduced()
    batch = multimodal.batch_for(cfg, 8, SEQ, seed=2)
    want = rsteps._micro_split(_jax(batch), 4)
    got = steps.micro_split(batch, 4)
    assert len(got) == 4
    for key in batch:
        for i, mb in enumerate(got):
            np.testing.assert_array_equal(_np(mb[key]), np.asarray(want[key][i], np.float32))
            assert torch.equal(mb[key], batch[key][i::4])
    with pytest.raises(ValueError, match="not a multiple"):
        steps.micro_split(batch, 3)


def test_moe_capacity_is_per_microbatch(ref, monkeypatch):
    """granite-moe-3b-a800m, global batch 8 x 32 in 4 microbatches of
    2 x 32: each MoE call sees 64 tokens, so capacity is the Switch
    formula's 40 slots (not 160 over the whole batch), pairs are dropped,
    and the step's loss equals the reference's."""
    r = ref("granite-moe-3b-a800m")
    cfg = r["cfg"]
    batch = multimodal.batch_for(cfg, 8, 32, seed=3)
    rstep, roptimizer, _ = rsteps.make_train_step(r["rcfg"], global_batch=8)
    _, _, rloss = jax.jit(rstep)(r["params"], roptimizer.init(r["params"]), _jax(batch))

    seen, real = [], moe.moe_ffn

    def spy(params, x, cfg, *, stats=None):
        stats = {} if stats is None else stats
        out = real(params, x, cfg, stats=stats)
        seen.append((x.shape[0] * x.shape[1], stats["capacity"], int((~stats["keep"]).sum())))
        return out

    monkeypatch.setattr(moe, "moe_ffn", spy)
    train_step, optimizer, model = steps.make_train_step(cfg, global_batch=8,
                                                         model=_port(cfg, r["tree"]))
    _, loss = train_step(optimizer.init(dict(model.named_parameters())), batch)
    n_moe = sum(model.use_moe[i % len(cfg.pattern)] for i in range(cfg.n_layers))
    # 4 microbatches' forwards; the backward's recompute may stop before it returns
    assert n_moe and len(seen) >= 4 * n_moe
    assert {(t, c) for t, c, _ in seen} == {(64, moe.capacity(cfg, 64))}
    assert moe.capacity(cfg, 64) == 40 and sum(d for _, _, d in seen) > 0
    np.testing.assert_allclose(float(loss), float(rloss), rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["smollm-360m", "xlstm-125m", "granite-moe-3b-a800m"])
def test_three_train_steps_reduce_loss(arch, ref):
    """The loss falls on a repeated batch (the reference's
    ``test_two_train_steps_reduce_loss``)."""
    r = ref(arch)
    train_step, optimizer, model = steps.make_train_step(
        r["cfg"], global_batch=2, model=_port(r["cfg"], r["tree"]))
    opt_state = optimizer.init(dict(model.named_parameters()))
    batch = multimodal.batch_for(r["cfg"], 2, SEQ, seed=7)
    losses = []
    for _ in range(3):
        opt_state, loss = train_step(opt_state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "xlstm-125m",
                                  "deepseek-v3-671b"])
def test_remat_changes_no_bit(arch, ref):
    """Per-layer checkpointing on and off: the same loss and gradients bit
    for bit."""
    r = ref(arch)
    batch = multimodal.batch_for(r["cfg"], 2, SEQ, seed=4)
    out = []
    for remat in (True, False):
        cfg = r["cfg"].with_(remat=remat)
        model = _port(cfg, r["tree"])
        loss = model.loss(batch)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_untouched_parameter_gets_zero_gradient_and_decay(ref):
    """A text-only batch leaves Phi-3-vision's projector out of the loss:
    its gradient is zero, not None (as ``jax.grad`` gives it), and AdamW's
    decoupled decay still moves it, by exactly ``-lr * wd * p``."""
    r = ref("phi-3-vision-4.2b")
    cfg = r["cfg"]
    train_step, optimizer, model = steps.make_train_step(cfg, global_batch=2,
                                                         model=_port(cfg, r["tree"]))
    before = model.projector.detach().clone()
    stats = {}
    train_step(optimizer.init(dict(model.named_parameters())),
               multimodal.text_batch(cfg, 2, SEQ, seed=5), stats)
    assert torch.equal(stats["grads"]["projector"], torch.zeros_like(before))
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32)
    assert torch.equal(model.projector.detach(), before + (-lr * 0.01 * before))


def test_train_step_on_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.make_train_step(base.get("smollm-360m").reduced(), global_batch=2)


# ------------------------------------------------------------- schedules
def test_schedules_match_reference():
    """The steps of the reference's own schedule tests, as Python ints and
    as 0-d tensors; float32 values."""
    pairs = [(schedules.constant(0.3), rschedules.constant(0.3), [0, 100]),
             (schedules.warmup_cosine(1.0, 10, 110, 0.1),
              rschedules.warmup_cosine(1.0, warmup_steps=10, total_steps=110, final_frac=0.1),
              [0, 5, *range(10, 111, 10), 200]),
             (schedules.inverse_sqrt(1.0, 100), rschedules.inverse_sqrt(1.0, warmup_steps=100),
              [0, 1, 50, 100, 400])]
    for fn, rfn, at in pairs:
        for step in at:
            want = np.asarray(rfn(jnp.int32(step)))
            for arg in (step, torch.tensor(step, dtype=torch.int32)):
                got = fn(arg)
                assert got.dtype == torch.float32 and got.shape == ()
                np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    fn = schedules.warmup_cosine(1.0, 10, 110, 0.1)
    assert float(fn(5)) == pytest.approx(0.5)
    assert float(fn(110)) == pytest.approx(0.1, abs=1e-6)


def test_schedule_drives_sgd_as_reference():
    opt = optimizers.make("sgd", schedules.inverse_sqrt(1.0, warmup_steps=4))
    ropt = roptimizers.make("sgd", rschedules.inverse_sqrt(1.0, warmup_steps=4))
    p, rp = {"x": torch.zeros(1)}, {"x": jnp.zeros(1)}
    s, rs = opt.init(p), ropt.init(rp)
    for _ in range(6):
        u, s = opt.update({"x": torch.ones(1)}, s, p)
        ru, rs = ropt.update({"x": jnp.ones(1)}, rs, rp)
        np.testing.assert_allclose(_np(u["x"]), np.asarray(ru["x"]), rtol=1e-6)
    assert s["step"] == 6


def test_synthetic_tokens_equal_reference():
    for args in [(0, 2, 8, 100), (7, 3, 33, 49152)]:
        got = pipeline.synthetic_tokens(*args)
        assert got.dtype == torch.long and got.shape == args[1:3]
        np.testing.assert_array_equal(got.numpy(), np.asarray(rpipeline.synthetic_tokens(*args)))


# -------------------------------------------------------------- launcher
def test_train_launcher_checkpoint_restores_in_reference(ref, tmp_path, capsys):
    """``run_reduced`` on the CPU returns a finite loss; its checkpoint
    restores through the reference's ``checkpoint.load(like=params)``, and
    both packages' losses on the restored parameters agree."""
    path = str(tmp_path / "smollm.npz")
    loss = train.run_reduced("smollm-360m", 3, 2, SEQ, ckpt=path, device="cpu")
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "[train] step    2" in out and "tok/s" in out and f"checkpoint -> {path}" in out
    r = ref("smollm-360m")
    restored, meta = rcheckpoint.load(path, like=r["params"])
    assert meta == {"arch": "smollm-360m", "step": 3}
    batch = multimodal.batch_for(r["cfg"], 2, SEQ, seed=9)
    rloss, _ = r["vg"](restored, _jax(batch))
    model = _port(r["cfg"], jax.tree.map(np.asarray, restored))
    with torch.no_grad():
        np.testing.assert_allclose(float(model.loss(batch)), float(rloss), rtol=LOSS_RTOL)


def test_train_main_on_cpu(capsys):
    train.main(["--arch", "xlstm-125m", "--reduced", "--steps", "2", "--batch", "2",
                "--seq", "8", "--device", "cpu"])
    assert "loss" in capsys.readouterr().out
