"""The port's chunked attention, MLA and MoE against the reference on the CPU.

Same numpy-seeded inputs and the reference's parameters (drawn by
``jax.random`` and carried across as numpy) go through both packages in
float32.  Tolerances: 1e-4 on attention outputs and logits (float32,
other summation orders), 2e-4 on MoE outputs (the reference's own MoE
test tolerance); routing (``expert_idx``, the kept mask, capacity) equal,
and the aux loss within 1e-6 relative (its mean router probability sums in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.launch import steps as rsteps
from repro.models import attention as rattention
from repro.models import moe as rmoe
from repro.models import multimodal as rmm
from repro.models import transformer as rtransformer
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.models import attention, moe, multimodal, transformer

ATOL = 1e-4
MOE_ATOL = 2e-4


def _t(tree):
    """numpy tree -> the same tree of float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d), dtype=np.float32)


def _pair(name, **change):
    return base.get(name).reduced().with_(**change), rbase.get(name).reduced().with_(**change)


# --------------------------------------------------------- chunked attention
@pytest.mark.parametrize("impl", ["chunked", "chunked_seqpar"])
@pytest.mark.parametrize("s,chunk,window", [
    (32, 8, 0), (32, 16, 0), (32, 32, 0),   # 4, 2 and 1 chunks
    (32, 8, 12), (32, 4, 3),                # windows: whole chunks fully masked
    (24, 8, 8),                             # the window a chunk wide
])
def test_chunked_attention_matches_reference(impl, s, chunk, window):
    cfg, rcfg = _pair("qwen3-4b", attention_impl=impl, attention_chunk=chunk,
                      sliding_window=window)
    params = jax.tree.map(np.asarray,
                          rattention.init_gqa_params(jax.random.PRNGKey(1), rcfg, jnp.float32))
    x = _x(2, s, cfg.d_model)
    want = rattention.chunked_gqa_attention(params, jnp.asarray(x), rcfg)
    got = attention.chunked_gqa_attention(_t(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    # the same function as the naive path's
    naive = attention.gqa_attention(_t(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(naive), atol=ATOL)


def test_chunked_attention_refuses_a_ragged_chunk():
    cfg = base.get("qwen3-4b").reduced().with_(attention_impl="chunked", attention_chunk=8)
    params = _t(jax.tree.map(np.asarray, rattention.init_gqa_params(
        jax.random.PRNGKey(1), rbase.get("qwen3-4b").reduced(), jnp.float32)))
    with pytest.raises(ValueError, match="multiple of attention_chunk"):
        attention.chunked_gqa_attention(params, torch.zeros((1, 12, cfg.d_model)), cfg)


# ----------------------------------------------------------------------- MLA
def _mla_params(rcfg, seed=2):
    return jax.tree.map(np.asarray,
                        rattention.init_mla_params(jax.random.PRNGKey(seed), rcfg, jnp.float32))


@pytest.mark.parametrize("s", [1, 8, 17])
def test_mla_attention_matches_reference(s):
    cfg, rcfg = _pair("deepseek-v3-671b")
    params = _mla_params(rcfg)
    x = _x(2, s, cfg.d_model, seed=s)
    want = rattention.mla_attention(params, jnp.asarray(x), rcfg)
    got = attention.mla_attention(_t(params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


def test_mla_decode_matches_reference_and_caches_the_latent():
    """The absorbed form step by step against the reference's absorbed
    form, then against the decompressed prefill; the cache holds kv_lora +
    rope values a token."""
    cfg, rcfg = _pair("deepseek-v3-671b")
    m = cfg.mla
    params = _mla_params(rcfg)
    b, n, cap = 2, 6, 8
    x = _x(b, n, cfg.d_model, seed=5)
    cache = attention.init_mla_cache(cfg, b, cap, torch.float32, "cpu")
    assert cache["ckv"].shape == (b, cap, m.kv_lora_rank)
    assert cache["krope"].shape == (b, cap, m.qk_rope_head_dim)
    assert sum(c[0, 0].numel() for c in cache.values()) == m.kv_lora_rank + m.qk_rope_head_dim
    rcache = rattention.init_mla_cache(rcfg, b, cap, jnp.float32)
    tparams = _t(params)
    got, want = [], []
    for t in range(n):
        out, cache = attention.mla_decode(tparams, torch.from_numpy(x[:, t:t + 1]), cache, t, cfg)
        rout, rcache = rattention.mla_decode(params, jnp.asarray(x[:, t:t + 1]), rcache,
                                             jnp.int32(t), rcfg)
        got.append(_np(out))
        want.append(_np(rout))
    np.testing.assert_allclose(np.concatenate(got, 1), np.concatenate(want, 1), atol=ATOL)
    np.testing.assert_allclose(_np(cache["ckv"]), _np(rcache["ckv"]), atol=ATOL)
    np.testing.assert_allclose(_np(cache["krope"]), _np(rcache["krope"]), atol=ATOL)
    full = attention.mla_attention(tparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(np.concatenate(got, 1), _np(full), atol=ATOL)


def test_mla_decode_refuses_a_position_past_the_cache():
    """The reference's dynamic_update_slice clamps such a position
    silently; the port raises (ROADMAP Queue 3)."""
    cfg, rcfg = _pair("deepseek-v3-671b")
    cache = attention.init_mla_cache(cfg, 1, 4, torch.float32, "cpu")
    with pytest.raises(IndexError, match="outside the MLA cache"):
        attention.mla_decode(_t(_mla_params(rcfg)), torch.zeros((1, 1, cfg.d_model)), cache, 4,
                             cfg)


def test_gqa_decode_refuses_a_position_past_the_cache():
    """The same for GQA without a window (a windowed cache is a ring)."""
    cfg, rcfg = _pair("granite-34b")
    params = _t(jax.tree.map(np.asarray, rattention.init_gqa_params(jax.random.PRNGKey(1), rcfg,
                                                                     jnp.float32)))
    cache = attention.init_gqa_cache(cfg, 1, 4, torch.float32, "cpu")
    with pytest.raises(IndexError):
        attention.gqa_decode(params, torch.zeros((1, 1, cfg.d_model)), cache, 4, cfg)


# ----------------------------------------------------------------------- MoE
def _ref_routing(params, x, rcfg):
    """expert_idx, keep (T, K) and capacity as the reference's moe_ffn
    computes them (its lines, which it does not return)."""
    m = rcfg.moe
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    t = xt.shape[0]
    e_bank = max(m.n_experts, m.pad_to)
    probs = jax.nn.softmax((xt @ params["router"]).astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, m.top_k)
    if m.dropless or t * m.top_k <= 64:
        cap = t * m.top_k
    else:
        cap = max(8, -(-t * m.top_k * int(100 * m.capacity_factor) // (100 * m.n_experts)))
    if m.dispatch == "per_k":
        counts = jnp.zeros((e_bank,), jnp.int32)
        keeps = []
        for k in range(m.top_k):
            e_k = expert_idx[:, k]
            oh = jax.nn.one_hot(e_k, e_bank, dtype=jnp.int32)
            pos = counts[e_k] + jnp.take_along_axis(
                jnp.cumsum(oh, axis=0) - oh, e_k[:, None], axis=1)[:, 0]
            counts = counts + oh.sum(0)
            keeps.append(pos < cap)
        keep = jnp.stack(keeps, 1)
    else:
        flat_e = expert_idx.reshape(-1)
        onehot = jax.nn.one_hot(flat_e, e_bank, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot, flat_e[:, None],
                                  axis=1)[:, 0]
        keep = (pos < cap).reshape(t, m.top_k)
    return np.asarray(expert_idx), np.asarray(keep), cap


_MOE_CASES = {
    "plain": dict(),
    "pad_to": dict(pad_to=6),
    "shared": dict(n_shared_experts=1),
    "drops": dict(capacity_factor=0.5),
    "top3_pad_shared": dict(top_k=3, pad_to=8, n_shared_experts=2),
    "dropless": dict(dropless=True, capacity_factor=0.5),
}


@pytest.mark.parametrize("dispatch", ["flat", "per_k"])
@pytest.mark.parametrize("case", list(_MOE_CASES))
def test_moe_ffn_matches_reference(dispatch, case):
    """4 x 16 tokens, top-2 of 4 experts: T*K = 128 > 64, so capacity is
    the Switch formula (40 at cf 1.25, 16 at cf 0.5, where pairs drop)."""
    change = _MOE_CASES[case]
    cfg = base.get("granite-moe-3b-a800m").reduced()
    moe_cfg = dataclasses.replace(cfg.moe, dispatch=dispatch, **change)
    cfg = cfg.with_(moe=moe_cfg)
    rcfg = rbase.get("granite-moe-3b-a800m").reduced().with_(
        moe=rbase.MoEConfig(**dataclasses.asdict(moe_cfg)))
    params = jax.tree.map(np.asarray, rmoe.init_moe_params(jax.random.PRNGKey(3), rcfg,
                                                           jnp.float32))
    x = _x(4, 16, cfg.d_model, seed=7)
    want_y, want_aux = rmoe.moe_ffn(params, jnp.asarray(x), rcfg)
    stats = {}
    got_y, got_aux = moe.moe_ffn(_t(params), torch.from_numpy(x), cfg, stats=stats)

    want_idx, want_keep, want_cap = _ref_routing(params, x, rcfg)
    assert stats["capacity"] == want_cap == moe.capacity(cfg, 64)
    np.testing.assert_array_equal(stats["expert_idx"].numpy(), want_idx)
    np.testing.assert_array_equal(stats["keep"].numpy(), want_keep)
    if case == "drops":
        assert not want_keep.all()
    elif case in ("plain", "dropless"):
        assert want_keep.all()
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=MOE_ATOL)
    assert got_aux.dtype == torch.float32
    # f_e (kept pairs per expert) is exact; the mean router probability
    # sums in another order, so aux agrees to float32 rounding
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6, atol=0)


@pytest.mark.parametrize("t,k,e,cf,dropless,want", [
    (8, 8, 40, 1.25, False, 64),        # T*K <= 64: dropless escape
    (9, 8, 40, 1.25, False, 8),         # ceil(72 * 125 / 4000) = 3, floored at 8
    (8192, 8, 40, 1.25, False, 2048),   # granite-moe prefill, 4 x 2048
    (2048, 8, 256, 1.25, False, 80),    # deepseek-v3 prefill, 4 x 512
    (64, 8, 256, 1.25, True, 512),      # dropless
    (100, 3, 7, 1.1, False, 48),        # ceil(300 * 110 / 700) = 48 (int(100 * 1.1) = 110)
])
def test_capacity_is_the_reference_integer_arithmetic(t, k, e, cf, dropless, want):
    cfg = base.get("granite-moe-3b-a800m").with_(
        moe=base.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf,
                           dropless=dropless))
    assert moe.capacity(cfg, t) == want


def test_routing_ties_go_to_the_lower_expert_index():
    """Equal probabilities: jax.lax.top_k orders them by lower index; the
    port's stable sort does the same (a tied router in bf16 is common)."""
    cfg = base.get("granite-moe-3b-a800m").reduced()
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=4))
    router = np.zeros((cfg.d_model, 8), np.float32)
    router[0] = [0, 1, 1, 0, 1, 0, 1, 1]            # five tied maxima, three tied minima
    x = np.zeros((3, cfg.d_model), np.float32)
    x[:, 0] = [1.0, -1.0, 0.0]
    _, _, idx = moe.route({"router": torch.from_numpy(router)}, torch.from_numpy(x), cfg)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert idx.tolist() == [[1, 2, 4, 6], [0, 3, 5, 1], [0, 1, 2, 3]]


# ------------------------------------------------- DeepSeek at full widths
def test_deepseek_full_attention_widths_match_reference():
    """DeepSeek-V3's attention at its published widths (d 7168, 128 heads,
    MLA ranks 1536 / 512, nope 128 + rope 64, v 128), 1 layer; experts
    (4 of width 128, top-2, 1 shared) and vocab (512) cut so the CPU run
    stays small.  Prefill at S = 8, then cached decode of the same tokens."""
    cut = dict(n_layers=1, vocab=512, dtype="float32")
    full = base.get("deepseek-v3-671b")
    moe_cut = dataclasses.replace(full.moe, n_experts=4, top_k=2, d_ff_expert=128)
    cfg = full.with_(moe=moe_cut, **cut)
    rcfg = rbase.get("deepseek-v3-671b").with_(
        moe=rbase.MoEConfig(**dataclasses.asdict(moe_cut)), **cut)
    assert (cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank, cfg.n_heads) == (1536, 512, 128)
    tree = jax.tree.map(np.asarray, rtransformer.Model(rcfg).init_params(jax.random.PRNGKey(0)))
    model = transformer.Model(cfg, device="cpu")
    model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    toks = multimodal.text_batch(cfg, 1, 8, seed=0)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstep, rmodel = rsteps.make_prefill_step(rcfg)
    want = _np(rstep(rparams, rmm.text_batch(rcfg, 1, 8, seed=0)))
    step, _ = steps.make_prefill_step(cfg, model=model)
    got = _np(step(toks))
    np.testing.assert_allclose(got, want, atol=ATOL)

    serve_step, _ = steps.make_serve_step(cfg, model=model)
    rserve_step, rmodel = rsteps.make_serve_step(rcfg)
    caches, rcaches = model.init_caches(1, 8), rmodel.init_caches(1, 8)
    for t in range(8):
        tok = toks["tokens"][:, t:t + 1]
        lg, caches = serve_step({"tokens": tok}, caches, t)
        rlg, rcaches = rserve_step(rparams, {"tokens": jnp.asarray(tok.numpy(), jnp.int32)},
                                   rcaches, jnp.int32(t))
        np.testing.assert_allclose(_np(lg)[:, 0], _np(rlg)[:, 0], atol=ATOL)
        np.testing.assert_allclose(_np(lg)[:, 0], got[:, t], atol=ATOL)
