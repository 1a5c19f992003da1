"""The port's flash attention (plain version, CPU) against the reference's
Pallas kernel in interpret mode: the same sweeps as
``tests/test_flash_attention.py``, on the same seeded numpy inputs.

Tolerances are the reference's own: 2e-5 for float32 (another summation
order), 2e-2 for bfloat16 outputs (one bf16 rounding of values near 1).
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


@pytest.mark.parametrize("s,hd", [(32, 16), (64, 32), (128, 64), (256, 128)])
def test_shape_sweep(s, hd):
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


def _gqa_cfgs(kv_heads):
    kw = dict(name="m", family="dense", n_layers=2, d_model=64, n_heads=4, kv_heads=kv_heads,
              d_ff=128, vocab=97, dtype="float32", attention_impl="flash")
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


@pytest.mark.parametrize("args", [(2, 32768, 15, 5, 64), (1, 4096, 32, 8, 128, 4, 256),
                                  (4, 2048, 15, 5, 64, 2, 512)])
def test_hbm_bytes_equal_reference(args):
    assert F.flash_hbm_bytes(*args) == RF.flash_hbm_bytes(*args)


def test_cpu_takes_plain_version_without_launch():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(2, 64, 16))
    before = F.LAUNCHES["flash"]
    got = F.flash_attention(tq, tk, tv)
    assert F.LAUNCHES["flash"] == before
    assert torch.equal(got, F._flash_plain(tq, tk, tv))


@pytest.mark.parametrize("bad", ["head_dim", "groups", "dtype", "rank"])
def test_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 32, 16))
    if bad == "head_dim":
        q, k, v = (torch.zeros(4, 32, 48) for _ in range(3))
    elif bad == "groups":
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
