"""The port's multimodal frontends (``repro_torch.models.multimodal`` and the
codebook / projector parts of ``models/transformer.py``) against the
reference on the CPU: Phi-3-vision (patch embeddings projected and
prepended to the text) and MusicGen (K codebooks summed per frame, K
heads).

The batches are seeded with numpy in both packages and must be equal bit
for bit.  The reference's parameters come from its own init and enter the
port through numpy; everything is float32, and logits agree within 1e-4
(float32 through 2 layers, other summation orders), as for the text
models.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import multimodal as rmm
from repro.models import transformer as rtransformer
from repro_torch.configs import base
from repro_torch.launch import serve, steps
from repro_torch.models import multimodal, transformer

ATOL = 1e-4
ARCHS = ["phi-3-vision-4.2b", "musicgen-large"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, rtransformer.Model(rcfg).init_params(jax.random.PRNGKey(seed)))


def _port(cfg, tree):
    model = transformer.Model(cfg, device="cpu")
    model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    return model


def _to_jax(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64 else v.numpy())
            for k, v in batch.items()}


def _same_batch(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        arr = np.asarray(arr)
        assert tuple(got[key].shape) == arr.shape, key
        if arr.dtype.kind == "f":
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
        else:
            assert got[key].dtype == torch.int64
            np.testing.assert_array_equal(got[key].numpy(), arr.astype(np.int64), err_msg=key)


# ------------------------------------------------------------------ batches
@pytest.mark.parametrize("name", ARCHS + ["smollm-360m"])
@pytest.mark.parametrize("full", [False, True])
def test_batches_equal_reference_bit_for_bit(name, full):
    cfg, rcfg = base.get(name), rbase.get(name)
    if not full:
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    s = 600 if full else 24
    for seed in (0, 5):
        _same_batch(multimodal.batch_for(cfg, 2, s, seed), rmm.batch_for(rcfg, 2, s, seed))
        _same_batch(multimodal.decode_batch_for(cfg, 3, seed), rmm.decode_batch_for(rcfg, 3, seed))
    _same_batch(multimodal.text_batch(cfg, 2, s, 1), rmm.text_batch(rcfg, 2, s, 1))


def test_vlm_and_audio_batches_equal_reference():
    cfg, rcfg = base.get("phi-3-vision-4.2b"), rbase.get("phi-3-vision-4.2b")
    got = multimodal.vlm_batch(cfg, 2, 2048, seed=3)
    _same_batch(got, rmm.vlm_batch(rcfg, 2, 2048, seed=3))
    assert got["image_embeds"].shape == (2, 576, 1024) and got["tokens"].shape == (2, 1472)
    with pytest.raises(ValueError, match="no text"):
        multimodal.vlm_batch(cfg, 1, 576)
    cfg, rcfg = base.get("musicgen-large"), rbase.get("musicgen-large")
    got = multimodal.audio_batch(cfg, 2, 100, seed=4)
    _same_batch(got, rmm.audio_batch(rcfg, 2, 100, seed=4))
    assert got["codes"].shape == (2, 100, 4) and int(got["codes"].max()) < 2048


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("name", ARCHS)
def test_params_round_trip_with_heads_and_projector(name):
    cfg = base.get(name).reduced()
    tree = _ref_params(rbase.get(name).reduced())
    assert ("heads" in tree) == (name == "musicgen-large")
    assert ("projector" in tree) == (name == "phi-3-vision-4.2b")
    model = _port(cfg, tree)  # strict: no key missing or extra
    back = transformer.params_to_numpy(cfg, model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert transformer.param_count(model) == rtransformer.param_count(tree)


@pytest.mark.parametrize("name,impl", [("phi-3-vision-4.2b", "naive"),
                                       ("phi-3-vision-4.2b", "flash"),
                                       ("musicgen-large", "naive"),
                                       ("musicgen-large", "flash")])
def test_prefill_logits_match_reference_reduced(name, impl):
    """Phi-3-vision: 8 projected patch embeddings + 32 text tokens;
    MusicGen: 40 frames of 4 codebooks, logits (B, S, K, V)."""
    rcfg = rbase.get(name).reduced().with_(attention_impl=impl)
    cfg = base.get(name).reduced().with_(attention_impl=impl)
    tree = _ref_params(rcfg)
    b, s = 2, 40
    batch = multimodal.batch_for(cfg, b, s, seed=0)
    rstep, _ = rsteps.make_prefill_step(rcfg)
    want = _np(jax.jit(rstep)(jax.tree.map(jnp.asarray, tree), _to_jax(batch)))
    step, _ = steps.make_prefill_step(cfg, model=_port(cfg, tree))
    got = _np(step(batch))
    shape = (b, s, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks else (b, s, cfg.vocab)
    assert got.shape == shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_vlm_without_image_embeds_is_text_only():
    cfg = base.get("phi-3-vision-4.2b").reduced()
    tree = _ref_params(rbase.get("phi-3-vision-4.2b").reduced())
    model = _port(cfg, tree)
    batch = multimodal.vlm_batch(cfg, 2, 20, seed=1)
    with_img, _ = model.prefill(batch)
    text, _ = model.prefill({"tokens": batch["tokens"]})
    assert with_img.shape[1] == 20 and text.shape[1] == 12
    x = model.embed_inputs(batch)
    torch.testing.assert_close(x[:, :8], batch["image_embeds"] @ model.projector, rtol=0, atol=0)


def _decode_both(name, n_pos, seed=1):
    rcfg, cfg = rbase.get(name).reduced(), base.get(name).reduced()
    tree = _ref_params(rcfg, seed=seed)
    key = "codes" if cfg.n_codebooks else "tokens"  # a VLM decodes text
    make = multimodal.audio_batch if cfg.n_codebooks else multimodal.text_batch
    toks = make(cfg, 2, n_pos, seed=1)
    rstep, rmodel = rsteps.make_serve_step(rcfg)
    rstep, rparams = jax.jit(rstep), jax.tree.map(jnp.asarray, tree)
    rcaches = rmodel.init_caches(2, n_pos)
    step, model = steps.make_serve_step(cfg, model=_port(cfg, tree))
    caches = model.init_caches(2, n_pos)
    got, want = [], []
    for t in range(n_pos):
        tok = {key: toks[key][:, t:t + 1]}
        lg, caches = step(tok, caches, t)
        rlg, rcaches = rstep(rparams, _to_jax(tok), rcaches, jnp.int32(t))
        got.append(_np(lg)[:, 0])
        want.append(_np(rlg)[:, 0])
    return np.stack(got, 1), np.stack(want, 1), model, toks


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_reference_and_prefill(name):
    got, want, model, toks = _decode_both(name, 6)
    np.testing.assert_allclose(got, want, atol=ATOL)
    full, _ = model.prefill(toks)
    np.testing.assert_allclose(got, _np(full), atol=ATOL)


def test_phi3_vision_run_reduced_tokens_equal_reference(capsys):
    """A VLM decodes text only, as in the reference."""
    arch, b, plen, gen = "phi-3-vision-4.2b", 2, 3, 5
    rserve.run_reduced(arch, b, plen, gen)
    printed = capsys.readouterr().out
    want_row0 = [int(t) for t in
                 re.search(r"sample continuation: \[([^\]]*)\]", printed).group(1).split(",")]
    tree = _ref_params(rbase.get(arch).reduced())
    got = serve.run_reduced(arch, b, plen, gen, device="cpu", params=tree)
    assert got.shape == (b, gen)
    assert got[0].tolist() == want_row0


def test_musicgen_run_reduced_tokens_equal_reference_per_codebook():
    """Greedy argmax per codebook, fed back as (B, 1, K): against the same
    loop over the reference's serve step.  (The reference's own
    ``run_reduced`` takes ``logits[..., -1, :]`` of (B, 1, K, V), the last
    codebook's logits, and feeds that one token to every codebook through
    clamped indexing: ROADMAP Queue 3.)"""
    arch, b, plen, gen = "musicgen-large", 2, 3, 5
    rcfg = rbase.get(arch).reduced()
    tree = _ref_params(rcfg)
    got = serve.run_reduced(arch, b, plen, gen, device="cpu", params=tree)
    assert got.shape == (b, gen, rcfg.n_codebooks)
    rstep, rmodel = rsteps.make_serve_step(rcfg)
    rstep, rparams = jax.jit(rstep), jax.tree.map(jnp.asarray, tree)
    caches = rmodel.init_caches(b, plen + gen)
    prompt = jnp.tile(rmm.decode_batch_for(rcfg, b)["codes"], (1, plen, 1))
    for t in range(plen):
        logits, caches = rstep(rparams, {"codes": prompt[:, t:t + 1]}, caches, jnp.int32(t))
    want = []
    for t in range(plen, plen + gen):
        nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]   # (B, 1, K)
        logits, caches = rstep(rparams, {"codes": nxt}, caches, jnp.int32(t))
        want.append(np.asarray(nxt))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "3", "--gen", "2",
                "--device", "cpu"])
    assert "sample continuation" in capsys.readouterr().out


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", ARCHS)
def test_config_and_reduced_field_for_field(name):
    port, ref = base.get(name), rbase.get(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.layer_kinds == ref.layer_kinds
