"""The port's checkpoints against the reference's file format on the CPU.

A file written by ``repro.checkpoint.save`` loads in ``repro_torch`` and
the reverse, for the same tree: the same '/'-joined keys, metadata and
values, and a model restored from the other package's file gives the same
logits.  bfloat16 leaves are written as the reference writes them, and
neither package restores them into a template (ROADMAP Queue 3 R4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.configs import base as rbase
from repro.launch import steps as rsteps
from repro.models import multimodal as rmm
from repro.models import transformer as rtransformer
from repro_torch import checkpoint as ckpt
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.models import multimodal, transformer

ATOL = 1e-4


def _tree_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"b": rng.standard_normal((4,)).astype(np.float32),
                        "step": np.int32(7)},
                       {"b": rng.standard_normal((4,)).astype(np.float32),
                        "step": np.int32(8)}],
            "pair": (np.arange(5, dtype=np.int64), rng.standard_normal((2, 2)))}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _assert_same(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_flat_load_reads_either_packages_file(tmp_path, writer):
    tree, meta = _tree_np(), {"step": 3, "arch": "x"}
    path = str(tmp_path / "c.npz")
    (ckpt.save if writer == "port" else rckpt.save)(path, _to_torch(tree) if writer == "port"
                                                    else tree, meta)
    got, got_meta = ckpt.load(path)
    want, want_meta = rckpt.load(path)
    assert got_meta == want_meta == meta
    assert sorted(got) == sorted(want) == ["layers/0/b", "layers/0/step", "layers/1/b",
                                           "layers/1/step", "pair/0", "pair/1", "w"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_port_and_reference_write_the_same_records(tmp_path):
    tree = _tree_np(1)
    ckpt.save(str(tmp_path / "p.npz"), _to_torch(tree), {"a": 1})
    rckpt.save(str(tmp_path / "r.npz"), tree, {"a": 1})
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "r.npz") as r:
        assert p.files == r.files
        for k in r.files:
            assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape
            np.testing.assert_array_equal(p[k], r[k])


def test_reference_file_restores_into_a_torch_template(tmp_path):
    tree = _tree_np(2)
    path = str(tmp_path / "r.npz")
    rckpt.save(path, tree, {"k": [1, 2]})
    like = _to_torch(jax.tree.map(np.zeros_like, tree))
    like["w"] = like["w"].to(torch.float64)   # cast to the template's dtype
    got, meta = ckpt.load(path, like=like)
    assert meta == {"k": [1, 2]}
    assert isinstance(got["pair"], tuple) and isinstance(got["layers"], list)
    assert got["w"].dtype == torch.float64
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].astype(np.float64))
    got["w"] = got["w"].to(torch.float32)
    _assert_same(got, tree)


def test_port_file_restores_in_the_reference(tmp_path):
    tree = _tree_np(3)
    path = str(tmp_path / "p.npz")
    ckpt.save(path, _to_torch(tree), None)
    got, meta = rckpt.load(path, like=jax.tree.map(jnp.asarray, tree))
    assert meta == {}
    _assert_same(jax.tree.map(np.asarray, got), jax.tree.map(lambda a: np.asarray(jnp.asarray(a)),
                                                             tree))


def test_numpy_template_gives_numpy_leaves(tmp_path):
    tree = _tree_np(4)
    path = str(tmp_path / "p.npz")
    ckpt.save(path, tree)
    got, _ = ckpt.load(path, like=tree)
    assert all(isinstance(leaf, np.ndarray) for leaf in jax.tree.leaves(got))
    _assert_same(got, tree)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_model_checkpoint_interchange_gives_the_same_logits(tmp_path, direction):
    """DeepSeek-V3 reduced (MLA, MoE expert banks (E, din, dout), shared
    expert, MTP head): a checkpoint written by one package restores the
    other's model, and both prefill the same logits."""
    name = "deepseek-v3-671b"
    cfg, rcfg = base.get(name).reduced(), rbase.get(name).reduced()
    rmodel = rtransformer.Model(rcfg)
    path = str(tmp_path / "m.npz")
    toks = multimodal.text_batch(cfg, 2, 12, seed=0)
    rprefill, _ = rsteps.make_prefill_step(rcfg)
    if direction == "port_to_reference":
        model = transformer.Model(cfg, device="cpu", seed=5)
        ckpt.save(path, transformer.params_to_numpy(cfg, model), {"arch": name})
        rparams, meta = rckpt.load(path, like=rmodel.init_params(jax.random.PRNGKey(1)))
    else:
        rparams = rmodel.init_params(jax.random.PRNGKey(1))
        rckpt.save(path, rparams, {"arch": name})
        model = transformer.Model(cfg, device="cpu", seed=5)
        like = transformer.params_to_numpy(cfg, model)
        tree, meta = ckpt.load(path, like=like)
        model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    assert meta == {"arch": name}
    want = np.asarray(rprefill(rparams, rmm.text_batch(rcfg, 2, 12, seed=0)))
    prefill, _ = steps.make_prefill_step(cfg, model=model)
    np.testing.assert_allclose(prefill(toks).numpy(), want, atol=ATOL)


def test_bf16_leaves_are_written_as_the_reference_writes_them(tmp_path):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    ckpt.save(str(tmp_path / "p.npz"), {"a": t, "b": [torch.ones(2)]})
    rckpt.save(str(tmp_path / "r.npz"), {"a": jnp.asarray(x).astype(jnp.bfloat16),
                                         "b": [jnp.ones(2)]})
    got, _ = ckpt.load(str(tmp_path / "p.npz"))
    want, _ = ckpt.load(str(tmp_path / "r.npz"))
    assert got["a"].dtype == want["a"].dtype == np.dtype("V2")
    assert got["a"].tobytes() == want["a"].tobytes()   # the same bf16 bits
    assert got["a"].tobytes() == t.view(torch.int16).numpy().tobytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_restore_raises_like_the_reference(tmp_path, writer):
    """The reference's load(like=) raises ValueError on a bf16 leaf; the
    port raises a ValueError that names the leaf and does not guess."""
    path = str(tmp_path / "c.npz")
    if writer == "port":
        ckpt.save(path, {"m": {"w": torch.ones((2, 2), dtype=torch.bfloat16)}})
    else:
        rckpt.save(path, {"m": {"w": jnp.ones((2, 2), jnp.bfloat16)}})
    with pytest.raises(ValueError, match="No cast function available"):
        rckpt.load(path, like={"m": {"w": jnp.ones((2, 2), jnp.bfloat16)}})
    with pytest.raises(ValueError, match="'m/w'.*No cast function available"):
        ckpt.load(path, like={"m": {"w": torch.ones((2, 2), dtype=torch.bfloat16)}})
