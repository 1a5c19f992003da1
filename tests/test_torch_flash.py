"""The port's flash attention (plain version, CPU) against the reference's
Pallas kernel in interpret mode: the same sweeps as
``tests/test_flash_attention.py``, on the same seeded numpy inputs.

Tolerances are the reference's own: 2e-5 for float32 (another summation
order), 2e-2 for bfloat16 outputs (one bf16 rounding of values near 1; the
port also rounds P to bf16 before P·V, as its wgmma kernel does).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.kernels import flash_attention as RF
from repro.models import attention as RA
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as F
from repro_torch.models import attention as A


def _qkv(bh, s, hd, seed=0, kv_bh=None):
    rng = np.random.default_rng(seed)
    kv_bh = kv_bh or bh
    q = rng.standard_normal((bh, s, hd), dtype=np.float32) * 0.5
    k = rng.standard_normal((kv_bh, s, hd), dtype=np.float32) * 0.5
    v = rng.standard_normal((kv_bh, s, hd), dtype=np.float32) * 0.5
    return q, k, v


def _both(arrs, dtype):
    """The same values as jax arrays and torch tensors of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _dense_oracle(q, k, v, causal=True, window=0):
    """Softmax attention on the full (S, S) scores, float32 numpy."""
    s = q.shape[1]
    sc = np.einsum("bsd,btd->bst", q, k)
    qp, kp = np.arange(s)[:, None], np.arange(s)[None, :]
    ok = kp <= qp if causal else np.ones((s, s), bool)
    if window:
        ok = ok & (kp > qp - window)
    sc = np.where(ok[None], sc, -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return np.einsum("bst,btd->bsd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("s,hd", [(32, 16), (64, 32), (128, 64), (256, 128), (128, 192),
                                  (128, 96), (128, 80)])
def test_shape_sweep(s, hd):
    """hd 80 is no compiled head dim: the CPU's plain version takes any, as
    the reference's kernel does."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(4, s, hd, seed=s), "float32")
    want = RF.flash_attention(jq, jk, jv, block_q=min(64, s), block_k=min(64, s),
                              interpret=True)
    got = F.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("bq,bk", [(16, 16), (16, 32), (64, 16), (128, 128)])
def test_block_sweep(bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 128, 32), "float32")
    want = RF.flash_attention(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(F.flash_attention(tq, tk, tv)), _np(want), atol=2e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_dtype_sweep(dtype, atol):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 64, 32), dtype)
    want = RF.flash_attention(jq, jk, jv, block_q=32, block_k=32, interpret=True)
    got = F.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("window", [4, 16, 64])
def test_sliding_window(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 64, 32, seed=window), "float32")
    want = RF.flash_attention(jq, jk, jv, window=window, block_q=16, block_k=16,
                              interpret=True)
    got = F.flash_attention(tq, tk, tv, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_non_causal(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 32, 16), "float32")
    want = RF.flash_attention(jq, jk, jv, causal=False, window=window, block_q=16,
                              block_k=16, interpret=True)
    got = F.flash_attention(tq, tk, tv, causal=False, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0), (False, 48)])
def test_ragged_length(causal, window):
    """S = 100: the kernel's last 64-row tile is part full."""
    q, k, v = _qkv(3, 100, 64, seed=7)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    got = _np(F.flash_attention(tq, tk, tv, causal=causal, window=window))
    want = RF.flash_attention(jq, jk, jv, causal=causal, window=window, interpret=True)
    np.testing.assert_allclose(got, _np(want), atol=2e-5)
    np.testing.assert_allclose(got, _dense_oracle(q, k, v, causal, window), atol=2e-5)


@pytest.mark.parametrize("groups", [1, 3, 4])
def test_groups_index_kv_heads(groups):
    """k, v of BH / groups heads equal the reference's repeat over groups."""
    q, k, v = _qkv(12, 64, 32, seed=groups, kv_bh=12 // groups)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    want = RF.flash_attention(jq, jnp.repeat(jk, groups, 0), jnp.repeat(jv, groups, 0),
                              block_q=32, block_k=32, interpret=True)
    got = F.flash_attention(tq, tk, tv, groups=groups)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


def _gqa_cfgs(kv_heads, d_model=64):
    kw = dict(name="m", family="dense", n_layers=2, d_model=d_model, n_heads=4,
              kv_heads=kv_heads, d_ff=128, vocab=97, dtype="float32", attention_impl="flash")
    return RefConfig(**kw), ModelConfig(**kw)


def _gqa_params(cfg, seed=1):
    rng = np.random.default_rng(seed)
    hd = cfg.resolved_head_dim
    shapes = {"wq": (cfg.d_model, cfg.n_heads * hd), "wk": (cfg.d_model, cfg.kv_heads * hd),
              "wv": (cfg.d_model, cfg.kv_heads * hd), "wo": (cfg.n_heads * hd, cfg.d_model)}
    return {k: (rng.standard_normal(s, dtype=np.float32) * s[0] ** -0.5) for k, s in shapes.items()}


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_gqa_layer_matches_naive_and_reference(kv_heads):
    rcfg, cfg = _gqa_cfgs(kv_heads)
    p = _gqa_params(cfg)
    x = np.random.default_rng(2).standard_normal((2, 32, 64), dtype=np.float32)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    flash = _np(F.gqa_flash_attention(tp, torch.from_numpy(x), cfg))
    np.testing.assert_allclose(flash, _np(A.gqa_attention(tp, torch.from_numpy(x), cfg)),
                               atol=2e-5)
    np.testing.assert_allclose(flash, _np(RA.gqa_attention(jp, jnp.asarray(x), rcfg)), atol=2e-5)
    np.testing.assert_allclose(flash, _np(RF.gqa_flash_attention(jp, jnp.asarray(x), rcfg)),
                               atol=2e-5)


@pytest.mark.parametrize("kv_heads", [1, 4])
def test_gqa_layer_at_hd_96_matches_naive_and_reference(kv_heads):
    """Phi-3-vision's head dim (4 heads of 96; g 4 and MHA), S 100: two
    64-row query tiles, the second part full."""
    rcfg, cfg = _gqa_cfgs(kv_heads, d_model=384)
    assert cfg.resolved_head_dim == 96
    p = _gqa_params(cfg)
    x = np.random.default_rng(3).standard_normal((2, 100, 384), dtype=np.float32)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    flash = _np(F.gqa_flash_attention(tp, torch.from_numpy(x), cfg))
    np.testing.assert_allclose(flash, _np(A.gqa_attention(tp, torch.from_numpy(x), cfg)),
                               atol=2e-5)
    np.testing.assert_allclose(flash, _np(RF.gqa_flash_attention(jp, jnp.asarray(x), rcfg)),
                               atol=2e-5)


@pytest.mark.parametrize("kv_heads,s", [(5, 100), (5, 200), (1, 130)])
def test_bf16_flash_layer_matches_reference_naive(kv_heads, s):
    """bf16 at SmolLM-360M's layer widths (d 960, 15 heads, hd 64): the
    port's flash layer (plain version: float32 scores, P rounded to bf16)
    against the reference's naive ``gqa_attention`` in bf16 (scores and
    probabilities rounded to bf16).  They differ by the rounding of the
    scores; atol: two bf16 steps (8 significant bits) at the outputs'
    largest magnitude."""
    kw = dict(name="m", family="dense", n_layers=2, d_model=960, n_heads=15,
              kv_heads=kv_heads, d_ff=128, vocab=97, dtype="bfloat16", attention_impl="flash")
    rcfg, cfg = RefConfig(**kw), ModelConfig(**kw)
    p = _gqa_params(cfg)
    x = np.random.default_rng(s).standard_normal((2, s, 960), dtype=np.float32)
    jp = {k: jnp.asarray(a).astype(jnp.bfloat16) for k, a in p.items()}
    tp = {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in p.items()}
    got = F.gqa_flash_attention(tp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    want = _np(RA.gqa_attention(jp, jnp.asarray(x).astype(jnp.bfloat16), rcfg))
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=2 * step)


@pytest.mark.parametrize("args", [(2, 32768, 15, 5, 64), (1, 4096, 32, 8, 128, 4, 256),
                                  (4, 2048, 15, 5, 64, 2, 512)])
def test_hbm_bytes_equal_reference(args):
    assert F.flash_hbm_bytes(*args) == RF.flash_hbm_bytes(*args)


def test_cpu_takes_plain_version_without_launch():
    for dtype in F.ROUTES:
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in _qkv(2, 64, 16))
        before = dict(F.LAUNCHES)
        got = F.flash_attention(tq, tk, tv)
        assert F.LAUNCHES == before
        assert torch.equal(got, F._flash_plain(tq, tk, tv))


def test_routes_name_launch_counts():
    """Each dtype has one kernel route on the card, counted under its own
    key and under the total "flash"."""
    assert F.ROUTES == {torch.bfloat16: "flash_wgmma", torch.float32: "flash_simt"}
    assert set(F.LAUNCHES) == {"flash", *F.ROUTES.values()}


def test_tma_alignment_is_checked():
    buf = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)
    F.check_tma_aligned(buf[:64].view(4, 16))
    with pytest.raises(ValueError, match="16-byte"):
        F.check_tma_aligned(buf[:64].view(4, 16), buf[1:].view(4, 16))


def test_bf16_plain_rounds_probabilities():
    """One kv tile (S = 64): the bf16 plain version is
    bf16((bf16(p) @ v) / sum(p)) with p = exp(s - max s) in float32; float32
    keeps p unrounded."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 64, 32, seed=5))
    qb, kb, vb = (t.to(torch.bfloat16).float() for t in (q, k, v))
    scores = qb @ kb.transpose(1, 2)
    scores = torch.where(torch.ones(64, 64, dtype=torch.bool).tril(), scores,
                         torch.tensor(F.NEG_INF))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    rounded = ((p.to(torch.bfloat16).float() @ vb) / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    unrounded = ((p @ vb) / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    got = F._flash_plain(*(t.to(torch.bfloat16) for t in (q, k, v)))
    assert torch.equal(got, rounded)
    assert not torch.equal(got, unrounded)
    assert torch.equal(F._flash_plain(qb, kb, vb), (p @ vb / p.sum(-1, keepdim=True)))


@pytest.mark.parametrize("bad", ["head_dim", "groups", "dtype", "rank"])
def test_rejects_what_the_kernel_does_not_take(bad):
    """A head dim outside ``HEAD_DIMS`` is refused by the CUDA routes only
    (before any launch); the rest by every device."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 32, 16))
    if bad == "head_dim":
        q, k, v = (torch.zeros(4, 32, 48) for _ in range(3))
        with pytest.raises(ValueError, match="compiled for head dims"):
            F._flash_cuda(q, k, v, True, 0, 1)
        assert F.flash_attention(q, k, v).shape == (4, 32, 48)
        return
    if bad == "groups":
        k, v = k[:3], v[:3]
    elif bad == "dtype":
        q = q.to(torch.float16)
    else:
        q = q[None]
    with pytest.raises(ValueError):
        F.flash_attention(q, k, v, groups=2 if bad == "groups" else 1)


def test_fully_masked_first_tile_gives_no_nan():
    """A window shorter than the tile: rows 67 .. 127 see nothing in kv
    tile 0 and get exp(0) terms that tile 1 wipes (-1e30, not -inf)."""
    q, k, v = _qkv(2, 192, 16, seed=3)
    got = _np(F._flash_plain(*(torch.from_numpy(a) for a in (q, k, v)), window=4))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _dense_oracle(q, k, v, True, 4), atol=2e-5)


def test_refuses_grad_like_the_reference():
    """The reference's kernel has no transpose rule (``jax.grad`` through it
    fails), and the port's has no backward: with grad enabled and an input
    that requires grad it raises on the CPU too, so a loss through
    ``attention_impl="flash"`` raises; under ``torch.no_grad()`` or
    without a grad-requiring input it runs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 32, 16))
    want = F.flash_attention(q, k, v)
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        F.flash_attention(qg, k, v)
    with torch.no_grad():
        assert torch.equal(F.flash_attention(qg, k, v), want)
    from repro_torch.configs import base
    from repro_torch.models import multimodal, transformer
    cfg = base.get("smollm-360m").reduced().with_(attention_impl="flash")
    model = transformer.Model(cfg, device="cpu")
    batch = multimodal.text_batch(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="has no backward"):
        model.loss(batch)
    assert torch.isfinite(model.prefill(batch)[0]).all()
