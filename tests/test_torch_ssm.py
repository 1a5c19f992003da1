"""The port's SSM / xLSTM mixers (``repro_torch.models.ssm``) and the
models built on them (Jamba, xLSTM) against the reference on the CPU.

Inputs are made from a seed with numpy; the reference's parameters come
from its own init (``jax.random`` streams cannot be reproduced in torch)
and enter the port through numpy.  Everything is float32.  Tolerances:
1e-5 for the chunked recurrence and one decode step (a handful of float32
operations an element, in another order: the log-depth scan here, XLA's
``associative_scan`` there); 1e-5 for a mixer's prefill where float32
holds it, 1e-4 for the mLSTM prefill (its intra-chunk einsums sum 32-term
products of exponentials in another order); 1e-4 on the logits of a whole
reduced model, as for the dense models.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs.base import ModelConfig as RModelConfig, SSMConfig as RSSMConfig
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import multimodal as rmm
from repro.models import ssm as rssm
from repro.models import transformer as rtransformer
from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.launch import serve, steps
from repro_torch.models import multimodal, ssm, transformer

ATOL = 1e-4
KINDS = ("mamba", "mlstm", "slstm")
REF = {"mamba": (rssm.init_mamba_params, rssm.mamba_mixer, rssm.init_mamba_state),
       "mlstm": (rssm.init_mlstm_params, rssm.mlstm_mixer, rssm.init_mlstm_state),
       "slstm": (rssm.init_slstm_params, rssm.slstm_mixer, rssm.init_slstm_state)}
PORT = {"mamba": (ssm.mamba_mixer, ssm.init_mamba_state),
        "mlstm": (ssm.mlstm_mixer, ssm.init_mlstm_state),
        "slstm": (ssm.slstm_mixer, ssm.init_slstm_state)}
#: a mixer's prefill against the reference's (see the module docstring)
PREFILL_TOL = {"mamba": 1e-5, "mlstm": 1e-4, "slstm": 1e-5}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _cfgs(kind, chunk=32, **kw):
    """A one-mixer config in both packages: d 64, 2 heads, d_state 8."""
    fields = dict(name="mini", family="ssm", n_layers=1, d_model=64, n_heads=4, kv_heads=2,
                  d_ff=0, vocab=97, pattern=(kind,), dtype="float32", **kw)
    return (ModelConfig(**fields, ssm=SSMConfig(d_state=8, chunk=chunk, n_heads=2)),
            RModelConfig(**fields, ssm=RSSMConfig(d_state=8, chunk=chunk, n_heads=2)))


def _mixer_params(kind, rcfg, seed=0):
    return jax.tree.map(np.asarray, REF[kind][0](jax.random.PRNGKey(seed), rcfg, jnp.float32))


def _x(b, s, d, seed=0, scale=0.5):
    return np.random.default_rng(seed).standard_normal((b, s, d), dtype=np.float32) * scale


# ------------------------------------------------- chunked linear recurrence
@pytest.mark.parametrize("s,chunk", [(64, 16), (70, 16), (40, 64), (5, 1)])
def test_linear_recurrence_chunked_matches_reference(s, chunk):
    """S a multiple of ``chunk`` (4 chunks), ragged (the reference's zero
    padding: ``h_last`` is then the padded state, 0), chunk > S, chunk 1."""
    rng = np.random.default_rng(s + chunk)
    a = rng.uniform(0.0, 1.0, (2, s, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, s, 3, 4), dtype=np.float32)
    h0 = rng.standard_normal((2, 3, 4), dtype=np.float32)
    got, got_last = ssm.linear_recurrence_chunked(*map(torch.from_numpy, (a, b, h0)), chunk)
    want, want_last = rssm.linear_recurrence_chunked(*map(jnp.asarray, (a, b, h0)), chunk)
    assert got.shape == (2, s, 3, 4) and got_last.shape == (2, 3, 4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(_np(got_last), _np(want_last), atol=1e-5)
    # and against the sequential recurrence itself
    h, seq = h0, []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(_np(got), np.stack(seq, 1), atol=1e-5)


def test_scan_survives_decays_that_underflow_a_cumulative_product():
    """a = exp(-exp(a_log) * dt) over 256 steps: the cumulative product is
    0 in float32, where cumprod-and-divide would give inf / NaN."""
    a = torch.full((1, 256, 2), 0.5)
    b = torch.ones((1, 256, 2))
    h, _ = ssm.linear_recurrence_chunked(a, b, torch.zeros((1, 2)), 256)
    assert float(torch.prod(a[0, :, 0])) == 0.0
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h[0, -1], torch.full((2,), 2.0), rtol=0, atol=1e-6)


# ------------------------------------------------------------------ mixers
@pytest.mark.parametrize("kind", KINDS)
def test_mixer_prefill_matches_reference(kind):
    """S = 2 chunks + a ragged tail of 7 (the mLSTM padding runs)."""
    cfg, rcfg = _cfgs(kind)
    tree = _mixer_params(kind, rcfg)
    x = _x(2, 71, cfg.d_model)
    got, st = PORT[kind][0](_t(tree), torch.from_numpy(x), cfg)
    want, _ = REF[kind][1](jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg)
    assert st is None and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=PREFILL_TOL[kind])


def _random_state(kind, cfg, b, rng):
    """A state of the mixer's layout with random contents (n > 0)."""
    d, h = cfg.d_model, cfg.ssm.n_heads
    hd = d // h
    di = cfg.ssm.expand * d
    std = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    if kind == "mamba":
        return {"h": std(b, di, cfg.ssm.d_state), "conv": std(b, cfg.ssm.d_conv - 1, di)}
    if kind == "mlstm":
        return {"c": std(b, h, hd, hd), "n": std(b, h, hd)}
    return {"c": std(b, d), "n": np.abs(std(b, d)) + 0.5, "h": std(b, d), "m": std(b, d)}


@pytest.mark.parametrize("kind", KINDS)
def test_mixer_decode_step_matches_reference(kind):
    cfg, rcfg = _cfgs(kind)
    tree = _mixer_params(kind, rcfg, seed=1)
    rng = np.random.default_rng(7)
    state = _random_state(kind, cfg, 2, rng)
    x = _x(2, 1, cfg.d_model, seed=2)
    got, got_st = PORT[kind][0](_t(tree), torch.from_numpy(x), cfg, state=_t(state))
    want, want_st = REF[kind][1](jax.tree.map(jnp.asarray, tree), jnp.asarray(x), rcfg,
                                 state=jax.tree.map(jnp.asarray, state))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    assert sorted(got_st) == sorted(want_st)
    for key in got_st:
        assert got_st[key].dtype == torch.float32
        np.testing.assert_allclose(_np(got_st[key]), _np(want_st[key]), atol=1e-5, err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_states_match_reference_layout(kind):
    for dtype, rdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        cfg, rcfg = _cfgs(kind)
        got = PORT[kind][1](cfg, 3, dtype, "cpu")
        want = REF[kind][2](rcfg, 3, rdtype)
        assert sorted(got) == sorted(want)
        for key, arr in want.items():
            assert tuple(got[key].shape) == arr.shape, key
            assert str(got[key].dtype)[6:] == str(arr.dtype), key
            assert not got[key].any()


# the port's own checks, mirroring the reference's
# tests/test_model_components.py (decode == full scan, causality)
@pytest.mark.parametrize("kind", KINDS)
def test_decode_matches_full_scan(kind):
    cfg, rcfg = _cfgs(kind, chunk=4)
    params = _t(_mixer_params(kind, rcfg))
    s = 6
    x = torch.from_numpy(_x(2, s, cfg.d_model, seed=3, scale=0.3))
    full, _ = PORT[kind][0](params, x, cfg)
    st = PORT[kind][1](cfg, 2, torch.float32, "cpu")
    outs = []
    for t in range(s):
        o, st = PORT[kind][0](params, x[:, t:t + 1], cfg, state=st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_causality(kind):
    cfg, rcfg = _cfgs(kind, chunk=4)
    params = _t(_mixer_params(kind, rcfg, seed=1))
    x = torch.from_numpy(_x(1, 8, cfg.d_model, seed=4, scale=1.0))
    y1, _ = PORT[kind][0](params, x, cfg)
    x2 = x.clone()
    x2[:, 5:] = 99.0
    y2, _ = PORT[kind][0](params, x2, cfg)
    torch.testing.assert_close(y1[:, :5], y2[:, :5], atol=1e-4, rtol=0)


def test_mlstm_padded_rows_stay_finite():
    """A ragged tail of 1 step in a chunk of 32: 31 padded rows whose
    i-gates are -1e30; the real rows' outputs are finite."""
    cfg, rcfg = _cfgs("mlstm")
    params = _t(_mixer_params("mlstm", rcfg))
    y, _ = ssm.mlstm_mixer(params, torch.from_numpy(_x(2, 33, cfg.d_model)), cfg)
    assert torch.isfinite(y).all()


# ------------------------------------------------------------ whole models
def _ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, rtransformer.Model(rcfg).init_params(jax.random.PRNGKey(seed)))


def _port(cfg, tree):
    model = transformer.Model(cfg, device="cpu")
    model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    return model


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_prefill_logits_match_reference_reduced(name):
    """Reduced: 2 periods (Jamba: 16 layers, 14 Mamba + 2 attention, MoE
    on every second layer; xLSTM: 2 x (mLSTM, sLSTM)), chunk 32, S = 2
    chunks + a ragged 7."""
    rcfg, cfg = rbase.get(name).reduced(), base.get(name).reduced()
    tree = _ref_params(rcfg)
    b, s = 2, 71
    toks = multimodal.text_batch(cfg, b, s, seed=0)
    rtoks = rmm.text_batch(rcfg, b, s, seed=0)
    rstep, _ = rsteps.make_prefill_step(rcfg)
    want = _np(jax.jit(rstep)(jax.tree.map(jnp.asarray, tree), rtoks))
    step, _ = steps.make_prefill_step(cfg, model=_port(cfg, tree))
    got = _np(step(toks))
    assert got.shape == (b, s, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_decode_matches_reference_and_prefill(name):
    """Cached decode through the SSM states (and Jamba's KV caches) against
    the reference's, and against the port's own prefill (MoE dropless)."""
    rcfg, cfg = rbase.get(name).reduced(), base.get(name).reduced()
    tree = _ref_params(rcfg, seed=1)
    n_pos = 6
    toks = multimodal.text_batch(cfg, 2, n_pos, seed=1)
    rstep, rmodel = rsteps.make_serve_step(rcfg)
    rstep, rparams = jax.jit(rstep), jax.tree.map(jnp.asarray, tree)
    rcaches = rmodel.init_caches(2, n_pos)
    step, model = steps.make_serve_step(cfg, model=_port(cfg, tree))
    caches = model.init_caches(2, n_pos)
    got, want = [], []
    for t in range(n_pos):
        tok = toks["tokens"][:, t:t + 1]
        lg, caches = step({"tokens": tok}, caches, t)
        rlg, rcaches = rstep(rparams, {"tokens": jnp.asarray(tok.numpy(), jnp.int32)}, rcaches,
                             jnp.int32(t))
        got.append(_np(lg)[:, 0])
        want.append(_np(rlg)[:, 0])
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if cfg.moe:
        model.cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, dropless=True))
    full, _ = model.prefill(toks)
    np.testing.assert_allclose(got, _np(full), atol=1e-3)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_run_reduced_tokens_equal_reference(arch, capsys):
    b, plen, gen = 2, 3, 5
    rserve.run_reduced(arch, b, plen, gen)
    printed = capsys.readouterr().out
    want_row0 = [int(t) for t in
                 re.search(r"sample continuation: \[([^\]]*)\]", printed).group(1).split(",")]
    tree = _ref_params(rbase.get(arch).reduced())
    got = serve.run_reduced(arch, b, plen, gen, device="cpu", params=tree)
    assert got.shape == (b, gen)
    assert got[0].tolist() == want_row0


def test_jamba_layers_follow_the_reference_pattern():
    """One period: Mamba everywhere but index 4 (attention), MoE on the
    odd layers (global index), dense FFN on the even ones."""
    cfg = base.get("jamba-v0.1-52b").reduced()
    model = transformer.Model(cfg, device="cpu")
    rcfg = rbase.get("jamba-v0.1-52b").reduced()
    assert cfg.layer_kinds == rcfg.layer_kinds and len(model.blocks) == 16
    for i, (blk, kind) in enumerate(zip(model.blocks, cfg.layer_kinds)):
        assert ("in_proj" in blk.mixer) == (kind == "mamba")
        assert hasattr(blk.ffn, "router") == (i % 2 == 1)
        assert model.use_moe[i % 8] == rcfg.is_moe_layer(i % 8, i // 8)


# ------------------------------------------------- the float32-leaf repair
F32_LEAVES = {"mamba": ("dt_bias", "a_log", "d_skip"), "mlstm": ("b_i", "b_f"), "slstm": ("b",)}


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_bf16_model_keeps_float32_leaves(name):
    """In a bf16 model the reference keeps the SSM mixers' gate / decay
    leaves float32: after the port's own init and after
    ``params_from_numpy`` of the reference's bf16 tree (values unrounded),
    and back through ``params_to_numpy``."""
    cfg = base.get(name).reduced().with_(dtype="bfloat16")
    rcfg = rbase.get(name).reduced().with_(dtype="bfloat16")
    assert ssm.FLOAT32_LEAVES == F32_LEAVES
    model = transformer.Model(cfg, device="cpu")
    tree = _ref_params(rcfg)
    state = transformer.params_from_numpy(cfg, tree)
    model.load_state_dict(state)
    own = transformer.Model(cfg, device="cpu").state_dict()
    n_f32 = 0
    for j, kind in enumerate(cfg.pattern):
        for leaf in F32_LEAVES.get(kind, ()):
            want = tree["blocks"][j]["mixer"][leaf]
            assert want.dtype == np.float32
            for p in range(cfg.n_periods):
                key = f"blocks.{p * len(cfg.pattern) + j}.mixer.{leaf}"
                for d in (own, state, model.state_dict()):
                    assert d[key].dtype == torch.float32, key
                np.testing.assert_array_equal(model.state_dict()[key].numpy(), want[p])
                n_f32 += 1
    assert n_f32 > 0
    assert model.blocks[0].norm1.dtype == torch.bfloat16
    back = transformer.params_to_numpy(cfg, model)
    for j, kind in enumerate(cfg.pattern):
        for leaf in F32_LEAVES.get(kind, ()):
            np.testing.assert_array_equal(back["blocks"][j]["mixer"][leaf],
                                          tree["blocks"][j]["mixer"][leaf])
    again = transformer.params_from_numpy(cfg, back)
    for key, val in model.state_dict().items():
        assert again[key].dtype == val.dtype, key


def test_bf16_mixers_run_with_float32_leaves():
    """A bf16 reduced Jamba and xLSTM prefill and decode one step."""
    for name in ("jamba-v0.1-52b", "xlstm-125m"):
        cfg = base.get(name).reduced().with_(dtype="bfloat16")
        model = transformer.Model(cfg, device="cpu")
        toks = multimodal.text_batch(cfg, 2, 9, seed=0)
        logits, _ = model.prefill(toks)
        assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
        step, _ = steps.make_serve_step(cfg, model=model)
        lg, caches = step({"tokens": toks["tokens"][:, :1]}, model.init_caches(2, 4), 0)
        assert lg.shape == (2, 1, cfg.vocab) and torch.isfinite(lg.float()).all()


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_config_and_reduced_field_for_field(name):
    port, ref = base.get(name), rbase.get(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.layer_kinds == ref.layer_kinds and port.n_periods == ref.n_periods
    assert ssm.mamba_dims(port) == rssm.mamba_dims(ref)


def test_serve_main_xlstm_on_cpu(capsys):
    serve.main(["--arch", "xlstm-125m", "--reduced", "--batch", "2", "--prompt-len", "3",
                "--gen", "2", "--device", "cpu"])
    assert "sample continuation" in capsys.readouterr().out
