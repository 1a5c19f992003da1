"""The port's dense-LM serving path against the reference on the CPU.

Both packages get the same inputs: tokens from the same numpy seeding, and
the reference's parameters (``jax.random`` streams cannot be reproduced in
torch) carried across with ``params_from_numpy``.  Everything is float32
(``reduced()`` sets it; numpy has no bf16), and the port's flash path runs
its plain version.  Tolerances: 1e-4 on logits (float32 through 2 layers:
other summation orders in the projections and the attention).
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import serve as rserve
from repro.launch import steps as rsteps
from repro.models import common as rcommon
from repro.models import multimodal as rmm
from repro.models import transformer as rtransformer
from repro_torch.configs import base
from repro_torch.launch import mesh, serve, steps, train
from repro_torch.models import blocks, common, multimodal, transformer

ATOL = 1e-4


def _ref_params(cfg, seed=0):
    params = rtransformer.Model(cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _port(cfg, tree):
    model = transformer.Model(cfg, device="cpu")
    model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    return model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ configs
_SYNTH = dict(name="synth", family="hybrid", n_layers=8, d_model=1024, n_heads=16,
              kv_heads=8, d_ff=4096, vocab=70_000, pattern=("attn", "mamba"),
              sliding_window=4096, n_prefix_embeds=576, prefix_embed_dim=1024)


def _synth(pkg):
    return pkg.ModelConfig(
        **_SYNTH, moe=pkg.MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, every=2),
        mla=pkg.MLAConfig(), ssm=pkg.SSMConfig())


NEW_ARCHS = ["granite-34b", "nemotron-4-340b", "granite-moe-3b-a800m", "deepseek-v3-671b"]


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-4b", "synth", *NEW_ARCHS])
def test_config_and_reduced_field_for_field(name):
    if name == "synth":
        port, ref = _synth(base), _synth(rbase)
    else:
        port, ref = base.get(name), rbase.get(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.layer_kinds == ref.layer_kinds
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.n_periods == ref.n_periods


def test_registry_holds_only_the_ported_architectures():
    assert base.all_names() == ["deepseek-v3-671b", "granite-34b", "granite-moe-3b-a800m",
                                "jamba-v0.1-52b", "musicgen-large", "nemotron-4-340b",
                                "phi-3-vision-4.2b", "qwen3-4b", "smollm-360m", "xlstm-125m"]
    assert base.INPUT_SHAPES == {k: base.InputShape(*dataclasses.astuple(v))
                                 for k, v in rbase.INPUT_SHAPES.items()}


# ------------------------------------------------------------------ common
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 64), dtype=np.float32)
    scale = rng.standard_normal((64,), dtype=np.float32)
    pos = np.arange(3, 15)[None, :].repeat(2, 0)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    js, ts = jnp.asarray(scale).astype(jd), torch.from_numpy(scale).to(td)
    atol = 1e-5 if dtype == "float32" else 1e-2
    got = common.rms_norm(tx, ts, 1e-5)
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(rcommon.rms_norm(jx, js, 1e-5)), atol=atol)
    for theta in (10_000.0, 1_000_000.0):
        got = common.apply_rope(tx, torch.from_numpy(pos), theta)
        assert got.dtype == td
        np.testing.assert_allclose(_np(got), _np(rcommon.apply_rope(jx, jnp.asarray(pos), theta)),
                                   atol=atol)


def test_causal_mask_and_activations_match_reference():
    for args in ((5, 9, 4, 0), (5, 9, 4, 3), (8, 8, 0, 0)):
        np.testing.assert_array_equal(_np(common.causal_mask(*args)),
                                      _np(rcommon.causal_mask(*args)))
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    for name in ("silu", "gelu", "relu2"):
        np.testing.assert_allclose(_np(common.activation_fn(name)(torch.from_numpy(x))),
                                   _np(rcommon.activation_fn(name)(jnp.asarray(x))), atol=1e-6)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 33), dtype=np.float32) * 3
    labels = rng.integers(0, 33, (2, 5), dtype=np.int32)
    got = common.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = rcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------------ params
def test_params_from_numpy_round_trip():
    """Every leaf of the reference's pytree lands in the port's model and
    reads back unchanged: top-level leaves by name, and slice p of
    ``blocks[j]`` as layer ``p * len(pattern) + j``."""
    cfg = base.get("qwen3-4b").reduced()
    tree = _ref_params(rbase.get("qwen3-4b").reduced())
    model = _port(cfg, tree)  # load_state_dict is strict: no key missing or extra
    state = model.state_dict()
    n_leaves = 0
    for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "blocks":
            j, *name = keys[1:]
            for p in range(cfg.n_periods):
                layer = p * len(cfg.pattern) + j
                np.testing.assert_array_equal(_np(state[f"blocks.{layer}.{'.'.join(name)}"]),
                                              arr[p])
                n_leaves += 1
        else:
            np.testing.assert_array_equal(_np(state[keys[0]]), arr)
            n_leaves += 1
    assert n_leaves == len(state)
    assert transformer.param_count(model) == rtransformer.param_count(tree)


# ----------------------------------------------------------------- prefill
def _prefill_both(rcfg, cfg, b, s):
    tree = _ref_params(rcfg)
    toks = multimodal.text_batch(cfg, b, s, seed=0)
    rtoks = rmm.text_batch(rcfg, b, s, seed=0)
    np.testing.assert_array_equal(toks["tokens"].numpy(), np.asarray(rtoks["tokens"]))
    rstep, _ = rsteps.make_prefill_step(rcfg)
    want = _np(jax.jit(rstep)(jax.tree.map(jnp.asarray, tree), rtoks))
    step, _ = steps.make_prefill_step(cfg, model=_port(cfg, tree))
    got = _np(step(toks))
    assert got.shape == (b, s, cfg.vocab)
    return got, want


@pytest.mark.parametrize("name", ["smollm-360m", "qwen3-4b"])
def test_prefill_logits_match_reference_reduced(name):
    rcfg = rbase.get(name).reduced().with_(attention_impl="flash")
    cfg = base.get(name).reduced().with_(attention_impl="flash")
    got, want = _prefill_both(rcfg, cfg, 2, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_prefill_logits_match_reference_smollm_full_widths():
    """d 960, 15 / 5 heads (BH not a power of two, g = 3), hd 64, d_ff 2560;
    2 layers and vocab 512 to keep the CPU run short."""
    cut = dict(n_layers=2, vocab=512, dtype="float32", attention_impl="flash")
    rcfg, cfg = rbase.get("smollm-360m").with_(**cut), base.get("smollm-360m").with_(**cut)
    got, want = _prefill_both(rcfg, cfg, 1, 128)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_naive_and_flash_prefill_agree():
    cfg = base.get("qwen3-4b").reduced()
    tree = _ref_params(rbase.get("qwen3-4b").reduced())
    toks = multimodal.text_batch(cfg, 2, 24, seed=3)
    naive, _ = _port(cfg, tree).prefill(toks)
    flash, _ = _port(cfg.with_(attention_impl="flash"), tree).prefill(toks)
    np.testing.assert_allclose(_np(flash), _np(naive), atol=ATOL)


# ------------------------------------------------------------------ decode
def _decode_both(rcfg, cfg, n_pos, capacity):
    tree = _ref_params(rcfg)
    toks = multimodal.text_batch(cfg, 2, n_pos, seed=1)
    rstep, rmodel = rsteps.make_serve_step(rcfg)
    rstep = jax.jit(rstep)
    rparams = jax.tree.map(jnp.asarray, tree)
    rcaches = rmodel.init_caches(2, capacity)
    step, model = steps.make_serve_step(cfg, model=_port(cfg, tree))
    caches = model.init_caches(2, capacity)
    got, want = [], []
    for t in range(n_pos):
        tok = toks["tokens"][:, t:t + 1]
        lg, caches = step({"tokens": tok}, caches, t)
        rlg, rcaches = rstep(rparams, {"tokens": jnp.asarray(tok.numpy(), jnp.int32)},
                             rcaches, jnp.int32(t))
        got.append(_np(lg)[:, 0])
        want.append(_np(rlg)[:, 0])
    return np.stack(got, 1), np.stack(want, 1), model, toks


def test_decode_step_matches_reference():
    cfg, rcfg = base.get("smollm-360m").reduced(), rbase.get("smollm-360m").reduced()
    got, want, model, toks = _decode_both(rcfg, cfg, 8, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the cache reproduces the full-sequence forward at every position
    full, _ = model.prefill(toks)
    np.testing.assert_allclose(got, _np(full), atol=ATOL)


def test_sliding_window_ring_buffer_matches_reference():
    """window 16 in a 20-token run: the cache holds 16 slots and wraps."""
    cfg = base.get("smollm-360m").reduced().with_(sliding_window=16)
    rcfg = rbase.get("smollm-360m").reduced().with_(sliding_window=16)
    got, want, model, toks = _decode_both(rcfg, cfg, 20, 20)
    assert model.init_caches(2, 20)[0]["k"].shape[1] == 16
    np.testing.assert_allclose(got, want, atol=ATOL)
    model.cfg = cfg.with_(attention_impl="flash")
    full, _ = model.prefill(toks)
    np.testing.assert_allclose(got, _np(full), atol=ATOL)


# ------------------------------------------------------------------- serve
def test_run_reduced_tokens_equal_reference(capsys):
    arch, b, plen, gen = "smollm-360m", 2, 4, 8
    rserve.run_reduced(arch, b, plen, gen)
    printed = capsys.readouterr().out
    want_row0 = [int(t) for t in
                 re.search(r"sample continuation: \[([^\]]*)\]", printed).group(1).split(",")]
    tree = _ref_params(rbase.get(arch).reduced())  # run_reduced's own PRNGKey(0) init
    got = serve.run_reduced(arch, b, plen, gen, device="cpu", params=tree)
    assert got.shape == (b, gen)
    assert got[0, :8].tolist() == want_row0
    # every request, against the reference's cached decode
    rcfg = rbase.get(arch).reduced()
    rstep, rmodel = rsteps.make_serve_step(rcfg)
    rstep, rparams = jax.jit(rstep), jax.tree.map(jnp.asarray, tree)
    caches = rmodel.init_caches(b, plen + gen)
    prompt = jnp.tile(rmm.decode_batch_for(rcfg, b)["tokens"], (1, plen))
    for t in range(plen):
        logits, caches = rstep(rparams, {"tokens": prompt[:, t:t + 1]}, caches, jnp.int32(t))
    want = []
    for t in range(plen, plen + gen):
        nxt = jnp.argmax(logits[..., -1, :], axis=-1).astype(jnp.int32).reshape(b, 1)
        logits, caches = rstep(rparams, {"tokens": nxt}, caches, jnp.int32(t))
        want.append(np.asarray(nxt))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


def test_serve_main_on_cpu_and_full_config_raises(capsys, tmp_path, monkeypatch):
    """``--reduced`` serves on the CPU; the full config returns its dry-run
    record and writes it (the name predates the dry-run)."""
    from repro_torch.launch import dryrun
    serve.main(["--arch", "qwen3-4b", "--reduced", "--batch", "2", "--prompt-len", "3",
                "--gen", "2", "--device", "cpu"])
    assert "sample continuation" in capsys.readouterr().out
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = serve.main(["--arch", "smollm-360m", "--device", "cpu"])
    assert rec["shape"] == "decode_32k" and (tmp_path / "smollm-360m__decode_32k__16x16.json").exists()


def test_cuda_requested_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.Model(base.get("smollm-360m").reduced())


@pytest.mark.parametrize("entry,item", [("train_full_config", "15"), ("serve_full_config", "15"),
                                        ("production_mesh", "15")])
def test_unported_entry_points_raise_naming_their_roadmap_item(entry, item, tmp_path,
                                                                monkeypatch):
    """The entry points of ROADMAP Queue 1 item ``item`` each return what
    the reference's returns, allocating on no device: the full configs'
    dry-run records, the production mesh's shape (the name predates the
    port of these entry points)."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"train_full_config": lambda: train.main(["--arch", "smollm-360m", "--device", "cpu"]),
            "serve_full_config": lambda: serve.main(["--arch", "smollm-360m", "--device", "cpu"]),
            "production_mesh": lambda: mesh.make_production_mesh()}[entry]
    got = call()
    if entry == "production_mesh":
        assert got.shape == {"data": 16, "model": 16}
        return
    shape = "train_4k" if entry == "train_full_config" else "decode_32k"
    assert (got["arch"], got["shape"], got["mesh"], got["chips"]) == (
        "smollm-360m", shape, "16x16", 256)
    assert got["flops_per_device"] > 0 and got["memory"]["argument_size_bytes"] > 0
    assert json.loads((tmp_path / f"smollm-360m__{shape}__16x16.json").read_text()) == got


def test_blocks_route_by_attention_impl(monkeypatch):
    calls = []
    for name, impl in (("gqa_flash_attention", "flash"), ("gqa_attention", "naive"),
                       ("chunked_gqa_attention", "chunked"), ("mla_attention", "mla")):
        target = blocks if impl == "flash" else blocks.attention
        monkeypatch.setattr(target, name, lambda p, x, cfg, impl=impl:
                            calls.append(impl) or torch.zeros_like(x))
    for impl in ("flash", "naive", "chunked", "chunked_seqpar"):
        cfg = base.get("smollm-360m").reduced().with_(attention_impl=impl)
        transformer.Model(cfg, device="cpu").prefill(multimodal.text_batch(cfg, 1, 4))
    cfg = base.get("deepseek-v3-671b").reduced().with_(attention_impl="flash")
    transformer.Model(cfg, device="cpu").prefill(multimodal.text_batch(cfg, 1, 4))
    assert calls == ["flash"] * 2 + ["naive"] * 2 + ["chunked"] * 4 + ["mla"] * 2


# ------------------------------------------------- MQA, relu2, MLA and MoE
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_prefill_logits_match_reference_new_archs(name):
    """granite-34b (MQA through the flash path), nemotron (squared ReLU),
    granite-moe (MoE) and deepseek (MLA + MoE with a shared expert)."""
    impl = "flash" if name == "granite-34b" else "naive"
    rcfg = rbase.get(name).reduced().with_(attention_impl=impl)
    cfg = base.get(name).reduced().with_(attention_impl=impl)
    got, want = _prefill_both(rcfg, cfg, 2, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_decode_matches_reference_new_archs(name):
    """Cached decode against the reference's, and against the port's own
    prefill (MoE made dropless, where both agree only then)."""
    cfg, rcfg = base.get(name).reduced(), rbase.get(name).reduced()
    got, want, model, toks = _decode_both(rcfg, cfg, 6, 8)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if cfg.moe:
        model.cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, dropless=True))
    full, _ = model.prefill(toks)
    np.testing.assert_allclose(got, _np(full), atol=ATOL)


def test_chunked_prefill_matches_reference_granite_34b():
    """MQA (one kv head, g = 4 at the reduced widths) through the chunked
    online softmax, 4 chunks."""
    cut = dict(attention_impl="chunked", attention_chunk=8)
    rcfg, cfg = rbase.get("granite-34b").reduced().with_(**cut), \
        base.get("granite-34b").reduced().with_(**cut)
    got, want = _prefill_both(rcfg, cfg, 2, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_active_param_count_matches_reference():
    for name in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        cfg, rcfg = base.get(name).reduced(), rbase.get(name).reduced()
        tree = _ref_params(rcfg)
        model = _port(cfg, tree)
        assert transformer.param_count(model) == rtransformer.param_count(tree)
        assert (transformer.active_param_count(cfg, model)
                == rtransformer.active_param_count(rcfg, tree))
        assert transformer.active_param_count(cfg, model) < transformer.param_count(model)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_params_to_numpy_inverts_params_from_numpy(name):
    """The reference's tree, through the port's model and back: the same
    structure (blocks per pattern entry, stacked over periods; MoE expert
    banks (E, din, dout); DeepSeek's MTP head) and the same values."""
    cfg = base.get(name).reduced()
    tree = _ref_params(rbase.get(name).reduced())
    back = transformer.params_to_numpy(cfg, _port(cfg, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_run_reduced_tokens_equal_reference_moe(arch, capsys):
    b, plen, gen = 2, 3, 5
    rserve.run_reduced(arch, b, plen, gen)
    printed = capsys.readouterr().out
    want_row0 = [int(t) for t in
                 re.search(r"sample continuation: \[([^\]]*)\]", printed).group(1).split(",")]
    tree = _ref_params(rbase.get(arch).reduced())
    got = serve.run_reduced(arch, b, plen, gen, device="cpu", params=tree)
    assert got.shape == (b, gen)
    assert got[0].tolist() == want_row0


def test_serve_main_deepseek_on_cpu(capsys):
    serve.main(["--arch", "deepseek-v3-671b", "--reduced", "--batch", "2", "--prompt-len", "3",
                "--gen", "2", "--device", "cpu"])
    assert "sample continuation" in capsys.readouterr().out
