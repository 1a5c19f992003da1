"""Sub-quadratic sequence mixers: Mamba selective SSM and xLSTM cells.

The reference's ``models/ssm.py`` in PyTorch, function for function.  All
three mixers share one primitive, the diagonal linear recurrence
    h_t = a_t * h_{t-1} + b_t          (elementwise on the state)
computed chunk by chunk: a loop over chunks carries the state, and within
a chunk a log-depth (Hillis-Steele) scan with the reference's combine
``(ax * ay, ay * bx + by)`` takes the place of ``lax.associative_scan``
(torch has none).  The cumprod-and-divide form is not used: over a chunk
of 256 steps ``a = exp(-exp(a_log) * dt)`` underflows, and the division
then blows up.

The reference has no Pallas kernel here (``lax.scan`` and
``lax.associative_scan``), so plain PyTorch is the port.  Where it departs
in memory, not arithmetic: ``mamba_mixer`` forms the (B, chunk, d_inner,
N) decay and input terms one chunk at a time, where the reference builds
them for the whole sequence (4 GiB each at Jamba's width and 4 x 2048
tokens); each element is computed by the same operations.

The reference's simplifications stand (documented in its module):
  * mLSTM uses log-space decay with per-row max stabilisation inside each
    chunk; normaliser lower-bounded at 1 on decode;
  * sLSTM is the exact sequential recurrence, a Python loop over steps here
    (``lax.scan`` there): one step's dozen small launches at a time.

``F.softplus`` stands for ``jax.nn.softplus``: its threshold (x > 20
returns x) is within float32's rounding of ``log1p(exp(x))`` there.

Dtypes follow the reference: the Mamba ``dt_bias``, ``a_log`` and
``d_skip``, the mLSTM ``b_i`` and ``b_f`` and the sLSTM ``b`` are float32
in a model of any dtype (``FLOAT32_LEAVES``), states are float32 except
Mamba's ``conv`` and sLSTM's ``h`` (model dtype).  Decode ignores ``pos``.

The three loops (Mamba's and mLSTM's over chunks, sLSTM's over steps) run
``loops.trip_loop``: ``range`` in every real run; under the dry-run's op
counter, three trips that count as all of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.loops import expand_trips, trip_loop

#: mixer leaves that the reference keeps in float32 whatever the model dtype
FLOAT32_LEAVES = {"mamba": ("dt_bias", "a_log", "d_skip"), "mlstm": ("b_i", "b_f"),
                  "slstm": ("b",)}

_F32 = torch.float32


# ------------------------------------------------- chunked linear recurrence
def _scan_chunk(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor):
    """One chunk: a, b (B, L, ...), h (B, ...) -> h_all (B, L, ...).

    Inclusive Hillis-Steele scan over axis 1 with the reference's combine
    ``(ax, bx) . (ay, by) = (ax * ay, ay * bx + by)`` (log2 L steps), then
    the carried state enters as ``aa * h + bb``."""
    length = a.shape[1]
    d = 1
    while d < length:
        a_new, b_new = a.clone(), b.clone()
        a_new[:, d:] = a[:, :-d] * a[:, d:]
        b_new[:, d:] = a[:, d:] * b[:, :-d] + b[:, d:]
        a, b = a_new, b_new
        d *= 2
    return a * h[:, None] + b


def linear_recurrence_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, chunk: int):
    """h_t = a_t * h_{t-1} + b_t.  a, b: (B, S, ...), h0: (B, ...).

    Returns (h (B, S, ...), h_last (B, ...)).  As in the reference, a
    sequence that ``chunk`` does not divide is zero-padded at the end
    (padded a = 0 -> padded h = 0, so ``h_last`` is the true final state
    only when S % chunk == 0)."""
    s = a.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        widths = [0, 0] * (a.dim() - 2) + [0, pad]
        a, b = F.pad(a, widths), F.pad(b, widths)
    h, outs = h0, []
    for c0 in range(0, s + pad, chunk):
        h_all = _scan_chunk(a[:, c0:c0 + chunk], b[:, c0:c0 + chunk], h)
        h = h_all[:, -1]
        outs.append(h_all)
    return torch.cat(outs, dim=1)[:, :s], h


# ------------------------------------------------------------------- Mamba
def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    d_inner, dt_rank, n = mamba_dims(cfg)
    dev = gen.device
    # S4D-real initialisation for A
    a_init = torch.arange(1, n + 1, dtype=_F32, device=dev).expand(d_inner, n)
    return nn.ParameterDict({
        "in_proj": common.init_dense(gen, cfg.d_model, 2 * d_inner, dtype),
        "conv_w": common.init_dense(gen, cfg.ssm.d_conv, d_inner, dtype,
                                    scale=cfg.ssm.d_conv ** -0.5),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_dtbc": common.init_dense(gen, d_inner, dt_rank + 2 * n, dtype),
        "dt_proj": common.init_dense(gen, dt_rank, d_inner, dtype, scale=dt_rank ** -0.5),
        "dt_bias": torch.full((d_inner,), -4.6, dtype=_F32, device=dev),  # softplus^-1(0.01)
        "a_log": torch.log(a_init),
        "d_skip": torch.ones((d_inner,), dtype=_F32, device=dev),
        "out_proj": common.init_dense(gen, d_inner, cfg.d_model, dtype),
    })


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv.  x (B, S, C), w (K, C).  With ``state``
    (B, K-1, C) performs a single-step update (S == 1) and returns
    (y, new_state)."""
    k = w.shape[0]
    if state is not None:
        buf = torch.cat([state, x], dim=1)                  # (B, K, C)
        y = torch.einsum("bkc,kc->bc", buf, w)[:, None] + b
        return y, buf[:, 1:]
    pad = F.pad(x, (0, 0, k - 1, 0))
    s = x.shape[1]
    y = 0
    for i in range(k):  # the reference's sum(...) starts from the int 0 too
        y = y + pad[:, i:i + s] * w[i]
    return y + b, None


def mamba_mixer(params, x: torch.Tensor, cfg: ModelConfig, *, state=None):
    """x (B, S, D) -> (y (B, S, D), new_state or None).

    ``state`` = {"h": (B, d_inner, N), "conv": (B, K-1, d_inner)} enables
    single-token decode (S == 1)."""
    b_sz, s_len, _ = x.shape
    d_inner, dt_rank, n = mamba_dims(cfg)
    decode = state is not None

    xz = x @ params["in_proj"]
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    xs, conv_state = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                  state["conv"] if decode else None)
    xs = F.silu(xs)

    dtbc = xs @ params["w_dtbc"]
    dt = F.softplus((dtbc[..., :dt_rank] @ params["dt_proj"]).to(_F32)
                    + params["dt_bias"])                                # (B, S, di)
    b_in = dtbc[..., dt_rank:dt_rank + n].to(_F32)                      # (B, S, N)
    c_in = dtbc[..., dt_rank + n:].to(_F32)                             # (B, S, N)
    neg_a = -torch.exp(params["a_log"])                                 # (di, N)
    dtx = dt * xs.to(_F32)

    def terms(s0: int, s1: int):
        """a and bu of steps [s0, s1): (B, s1 - s0, di, N) each."""
        a = torch.exp(neg_a * dt[:, s0:s1, :, None])
        bu = dtx[:, s0:s1, :, None] * b_in[:, s0:s1, None, :]
        return a, bu

    if decode:
        a, bu = terms(0, 1)
        h = state["h"] * a[:, 0] + bu[:, 0]                            # (B, di, N)
        y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None]
        new_state = {"h": h, "conv": conv_state}
    else:
        # the reference's linear_recurrence_chunked, its (B, chunk, di, N)
        # terms formed one chunk at a time; a ragged tail chunk is scanned
        # at its own length (the reference's zero padding only adds steps
        # after it, which it cuts)
        chunk = min(cfg.ssm.chunk, s_len)
        n_chunks = -(-s_len // chunk)
        h = torch.zeros((b_sz, d_inner, n), dtype=_F32, device=x.device)
        ys = []
        for i in trip_loop(n_chunks):
            s0, s1 = i * chunk, min((i + 1) * chunk, s_len)
            h_all = _scan_chunk(*terms(s0, s1), h)
            h = h_all[:, -1]
            ys.append(torch.einsum("bsdn,bsn->bsd", h_all, c_in[:, s0:s1]))
            del h_all
        y = torch.cat(expand_trips(ys, n_chunks), dim=1)
        new_state = None

    y = (y + params["d_skip"] * xs.to(_F32)).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["out_proj"], new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_inner, _, n = mamba_dims(cfg)
    return {"h": torch.zeros((batch, d_inner, n), dtype=_F32, device=device),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner), dtype=dtype,
                                device=device)}


# ------------------------------------------------------------------- mLSTM
def init_mlstm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    h = cfg.ssm.n_heads
    d = cfg.d_model
    dev = gen.device
    return nn.ParameterDict({
        "wq": common.init_dense(gen, d, d, dtype),
        "wk": common.init_dense(gen, d, d, dtype),
        "wv": common.init_dense(gen, d, d, dtype),
        "w_if": common.init_dense(gen, d, 2 * h, dtype, scale=0.02),
        "b_i": torch.zeros((h,), dtype=_F32, device=dev),
        "b_f": torch.full((h,), 3.0, dtype=_F32, device=dev),  # forget-gate bias -> remember
        "w_gate": common.init_dense(gen, d, d, dtype),
        "wo": common.init_dense(gen, d, d, dtype),
    })


def _mlstm_chunk(c_st, n_st, qk, kk, vk, lik, lfk):
    """One chunk of the mLSTM prefill: inter-chunk state carried exactly,
    intra-chunk decay-masked linear attention in log space (float32).
    Returns (c_new, n_new, y (B, chunk, H, hd))."""
    chunk = qk.shape[1]
    qk, kk, vk = qk.to(_F32), kk.to(_F32), vk.to(_F32)
    cum_f = torch.cumsum(lfk, dim=1)                                    # (B, chunk, H)
    # intra-chunk decay matrix: D[s, t] = exp(cumf_s - cumf_t + i_t), t <= s
    dmat = cum_f[:, :, None] - cum_f[:, None, :] + lik[:, None, :, :]   # (B, S, T, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=qk.device))
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    # stabilise rows against both the intra max and the inter decay
    m_row = torch.maximum(dmat.amax(dim=2), cum_f)                      # (B, S, H)
    w_intra = torch.exp(dmat - m_row[:, :, None])                       # (B, S, T, H)
    scores = torch.einsum("bshd,bthd->bsth", qk, kk)
    y_intra = torch.einsum("bsth,bthd->bshd", scores * w_intra, vk)
    n_intra = torch.einsum("bsth,bthd->bshd", w_intra, kk)
    # inter-chunk: contribution of the carried state
    w_inter = torch.exp(cum_f - m_row)                                  # (B, S, H)
    y_inter = torch.einsum("bshd,bhdv->bshv", qk, c_st) * w_inter[..., None]
    n_inter = torch.einsum("bshd,bhd->bsh", qk, n_st)[..., None] * w_inter[..., None]
    num = y_intra + y_inter
    den = torch.abs(torch.einsum("bshd,bshd->bsh", qk, n_intra)[..., None] + n_inter)
    y = num / torch.maximum(den, torch.exp(-m_row)[..., None])
    # exact state update to the end of the chunk
    tot_f = cum_f[:, -1]                                                # (B, H)
    wk_end = torch.exp(tot_f[:, None] - cum_f + lik)                    # (B, chunk, H)
    c_new = c_st * torch.exp(tot_f)[..., None, None] + \
        torch.einsum("bthd,bthv,bth->bhdv", kk, vk, wk_end)
    n_new = n_st * torch.exp(tot_f)[..., None] + torch.einsum("bthd,bth->bhd", kk, wk_end)
    return c_new, n_new, y


def mlstm_mixer(params, x: torch.Tensor, cfg: ModelConfig, *, state=None):
    """Matrix-memory LSTM: C_t = f_t C_{t-1} + i_t v_t k_t^T, y_t = C_t q_t.

    Prefill: chunked, the state carried exactly across chunks.  Decode
    (state given): the exact single-step recurrence.
    state = {"c": (B, H, dk, dv), "n": (B, H, dk)}."""
    b_sz, s_len, d = x.shape
    h = cfg.ssm.n_heads
    hd = d // h

    q = (x @ params["wq"]).reshape(b_sz, s_len, h, hd) * hd ** -0.5
    k = (x @ params["wk"]).reshape(b_sz, s_len, h, hd) * hd ** -0.5
    v = (x @ params["wv"]).reshape(b_sz, s_len, h, hd)
    gates = (x @ params["w_if"]).to(_F32).reshape(b_sz, s_len, 2, h)
    log_i = -F.softplus(-(gates[:, :, 0] + params["b_i"]))              # log sigmoid
    log_f = -F.softplus(-(gates[:, :, 1] + params["b_f"]))

    if state is not None:
        i_t, f_t = torch.exp(log_i[:, 0]), torch.exp(log_f[:, 0])      # (B, H)
        qh, kh, vh = q[:, 0].to(_F32), k[:, 0].to(_F32), v[:, 0].to(_F32)
        c = state["c"] * f_t[..., None, None] + \
            i_t[..., None, None] * torch.einsum("bhk,bhv->bhkv", kh, vh)
        n = state["n"] * f_t[..., None] + i_t[..., None] * kh
        num = torch.einsum("bhkv,bhk->bhv", c, qh)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, qh)), min=1.0)
        y = (num / den[..., None]).reshape(b_sz, 1, d)
        new_state = {"c": c, "n": n}
    else:
        chunk = min(cfg.ssm.chunk, s_len)
        pad = (-s_len) % chunk
        if pad:
            # zero-pad the tail chunk: padded keys / values contribute
            # nothing (k = v = 0); padded i-gates get the finite -1e30 (not
            # -inf), so they never write state and their rows stay finite
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
            log_f = F.pad(log_f, (0, 0, 0, pad))
        c_st = torch.zeros((b_sz, h, hd, hd), dtype=_F32, device=x.device)
        n_st = torch.zeros((b_sz, h, hd), dtype=_F32, device=x.device)
        ys = []
        n_chunks = (s_len + pad) // chunk
        for i in trip_loop(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            c_st, n_st, y_k = _mlstm_chunk(c_st, n_st, q[:, sl], k[:, sl], v[:, sl],
                                           log_i[:, sl], log_f[:, sl])
            ys.append(y_k)
        y = torch.cat(expand_trips(ys, n_chunks), dim=1)[:, :s_len].reshape(b_sz, s_len, d)
        new_state = None

    y = y.to(x.dtype) * F.silu(x @ params["w_gate"])
    return y @ params["wo"], new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    h = cfg.ssm.n_heads
    hd = cfg.d_model // h
    return {"c": torch.zeros((batch, h, hd, hd), dtype=_F32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=_F32, device=device)}


# ------------------------------------------------------------------- sLSTM
def init_slstm_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    h = cfg.ssm.n_heads
    d = cfg.d_model
    hd = d // h
    dev = gen.device
    r = common.randn(gen, (4, h, hd, hd)) * hd ** -0.5
    return nn.ParameterDict({
        "w_in": common.init_dense(gen, d, 4 * d, dtype),
        # block-diagonal recurrent weights per head: (4, H, hd, hd)
        "r": r.to(dtype),
        "b": torch.cat([torch.zeros((2 * d,), dtype=_F32, device=dev),
                        torch.full((d,), 3.0, dtype=_F32, device=dev),
                        torch.zeros((d,), dtype=_F32, device=dev)]),
        "wo": common.init_dense(gen, d, d, dtype),
    })


def slstm_mixer(params, x: torch.Tensor, cfg: ModelConfig, *, state=None):
    """Scalar-memory LSTM with recurrent block-diagonal connections.

    The exact sequential recurrence (z, i, f, o gates; stabiliser m), one
    step at a time: state = {"c", "n", "h", "m"}, each (B, D), float32
    except ``h`` (model dtype).  The recurrent product runs in ``r``'s
    dtype and is then cast to float32, as in the reference."""
    b_sz, s_len, d = x.shape
    h_heads = cfg.ssm.n_heads
    hd = d // h_heads
    r = params["r"]
    bias = params["b"].reshape(4, d)[:, None]                           # (4, 1, D)
    pre_all = (x @ params["w_in"]).to(_F32).reshape(b_sz, s_len, 4, d)

    if state is None:
        zeros = torch.zeros((b_sz, d), dtype=_F32, device=x.device)
        c, n, hm, m = zeros, zeros, torch.zeros((b_sz, d), dtype=x.dtype, device=x.device), zeros
    else:
        c, n, hm, m = state["c"], state["n"], state["h"], state["m"]

    hs = []
    pre_steps = pre_all.unbind(1)   # one op, so the backward stacks S step grads once
    for t in trip_loop(s_len):
        hr = hm.reshape(b_sz, h_heads, hd).to(r.dtype)
        rec = torch.einsum("bhd,ghde->gbhe", hr, r).to(_F32).reshape(4, b_sz, d)
        pre = pre_steps[t].transpose(0, 1) + rec + bias
        z_t = torch.tanh(pre[0])
        i_log = pre[1]
        f_log = -F.softplus(-pre[2])                                     # log sigmoid(f)
        o_t = torch.sigmoid(pre[3])
        m_new = torch.maximum(f_log + m, i_log)
        i_t = torch.exp(i_log - m_new)
        f_t = torch.exp(f_log + m - m_new)
        c = f_t * c + i_t * z_t
        n = torch.clamp(f_t * n + i_t, min=1e-6)
        h_new = o_t * (c / n)
        m = m_new
        hm = h_new.to(x.dtype)
        hs.append(hm)
    y = torch.stack(expand_trips(hs, s_len), dim=1)                     # (B, S, D)
    new_state = {"c": c, "n": n, "h": hm, "m": m} if state is not None else None
    return y @ params["wo"], new_state


def init_slstm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    zeros = lambda: torch.zeros((batch, d), dtype=_F32, device=device)  # noqa: E731
    return {"c": zeros(), "n": zeros(), "h": torch.zeros((batch, d), dtype=dtype, device=device),
            "m": zeros()}
