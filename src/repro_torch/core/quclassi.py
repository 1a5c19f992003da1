"""The DQuLearn training workload: a quantum-classical CNN classifier
(QuClassi as used by the paper, Algorithm 1).

Pipeline per image:
  Task Segmentation -> patches (B, Np, w*w)
  classical dense layer -> data-encoding angles per patch (Algorithm 1 l.10)
  per class c: SWAP-test fidelity F_c(patch) against trainable register theta_c
  class score = mean over patches of F_c; one-vs-all BCE loss.

Two gradient paths:
  * ``grad_shift``    — the paper's distributed path: parameter-shift circuit
    bank per class, executable by any ``Executor`` (the statevector kernels,
    per worker through the data plane); the dense layer's exact gradient on
    the two m-qubit registers (``kernels/dense_grad.py``).
  * ``grad_autodiff`` — exact gradients through the dense simulator.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.api.capabilities import capabilities_of
from repro_torch.core import circuits, fidelity as fid, segmentation, shift_rule
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels import dense_grad


@dataclasses.dataclass(frozen=True)
class QuClassiConfig:
    qc: int = 5                   # qubit count (paper: 5 or 7)
    n_layers: int = 1             # 1..3 (single / +dual / +entangle)
    n_classes: int = 2
    seg: segmentation.SegmentationConfig = segmentation.SegmentationConfig()
    image_size: tuple[int, int] = (8, 8)   # paper downsamples MNIST patches
    use_dense: bool = True

    @property
    def spec(self) -> CircuitSpec:
        return circuits.build_quclassi_circuit(self.qc, self.n_layers)

    @property
    def n_theta(self) -> int:
        return circuits.n_theta_for(self.qc, self.n_layers)

    @property
    def n_angles(self) -> int:
        return circuits.n_data_angles_for(self.qc)

    @property
    def patch_dim(self) -> int:
        return self.seg.filter_width**2

    @property
    def n_patches(self) -> int:
        ph, pw = segmentation.n_patches(*self.image_size, self.seg)
        return ph * pw


def init_params(cfg: QuClassiConfig, generator: torch.Generator, device="cpu") -> dict:
    """Network weights: theta ~ U[0, pi] per class (Algorithm 1 l.2), dense
    weights ~ N(0, 1/patch_dim), drawn on the CPU from ``generator``."""
    theta = torch.rand((cfg.n_classes, cfg.n_theta), generator=generator) * math.pi
    params = {"theta": theta}
    if cfg.use_dense:
        scale = 1.0 / math.sqrt(cfg.patch_dim)
        params["w"] = torch.randn((cfg.patch_dim, cfg.n_angles), generator=generator) * scale
        params["b"] = torch.zeros((cfg.n_angles,))
    return {k: v.to(device) for k, v in params.items()}


def params_from_numpy(params: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The reference's ``{"theta": (C,P), "w": (patch_dim, n_angles),
    "b": (n_angles,)}`` as float32 tensors on ``device``."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        for k, v in params.items()
    }


def encode_patches(cfg: QuClassiConfig, params: dict, patches: torch.Tensor) -> torch.Tensor:
    """(B, Np, w*w) patches -> (B, Np, n_angles) rotation angles."""
    if cfg.use_dense:
        z = patches @ params["w"] + params["b"]            # dense layer (l.10-11)
        return math.pi * torch.sigmoid(z)
    from repro_torch.core import encoding
    return encoding.rotation_angles(patches, cfg.n_angles)


def class_fidelities(cfg: QuClassiConfig, params: dict, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images -> (B, n_classes) mean patch fidelity per class."""
    patches = segmentation.segment(images, cfg.seg)        # (B, Np, P)
    angles = encode_patches(cfg, params, patches)          # (B, Np, A)
    flat = angles.reshape(-1, angles.shape[-1])            # (B*Np, A)
    theta = params["theta"][:, None, :]                    # (C, 1, P)
    f = fid.fidelity_batch(cfg.spec, theta, flat[None])    # (C, B*Np)
    return f.reshape(f.shape[0], angles.shape[0], -1).mean(-1).T  # (B, C)


def one_vs_all_loss(fids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """fids (B, C), integer labels (B,) -> scalar mean BCE over classes."""
    onehot = F.one_hot(labels.long(), fids.shape[-1]).to(fids.dtype)
    return fid.bce_loss(fids, onehot).mean()


def predict(cfg: QuClassiConfig, params: dict, images: torch.Tensor) -> torch.Tensor:
    return class_fidelities(cfg, params, images).argmax(-1)


def accuracy(cfg: QuClassiConfig, params: dict, images, labels) -> torch.Tensor:
    return (predict(cfg, params, images) == labels).to(torch.float32).mean()


# ------------------------------------------------------------ gradient paths
def grad_autodiff(cfg: QuClassiConfig, params: dict, images, labels):
    """Exact gradients for all parameters (dense + quantum) via the simulator."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    f = class_fidelities(cfg, leaves, images)
    loss = one_vs_all_loss(f, labels)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), f.detach()


def encode_images(cfg: QuClassiConfig, params: dict, images: torch.Tensor):
    """(B, H, W) images -> (angles (B*Np, A), patches (B*Np, w*w)): each
    patch and the rotation angles it encodes."""
    patches = segmentation.segment(images, cfg.seg)
    angles = encode_patches(cfg, params, patches).reshape(-1, cfg.n_angles)
    return angles, patches.reshape(-1, cfg.patch_dim)


def build_class_banks(
    cfg: QuClassiConfig, params: dict, images: torch.Tensor, implicit: bool = False
):
    """The distributable work unit: one circuit bank per class (Algorithm 1).

    Returns (banks, angles) where banks[c] covers every (patch, shifted-theta)
    circuit for class c.  Total circuits = C * (B*Np) * (2*P + 1).
    ``implicit=True`` builds ``ShiftBank``s (base angles + shift descriptors).
    """
    angles, _ = encode_images(cfg, params, images)
    return _banks_of(params, angles, cfg.n_classes, implicit), angles


def _banks_of(params: dict, angles: torch.Tensor, n_classes: int, implicit: bool) -> list:
    build = shift_rule.build_shift_bank if implicit else shift_rule.build_bank
    return [build(params["theta"][c], angles) for c in range(n_classes)]


def dense_chain_weights(fids: torch.Tensor, onehot: torch.Tensor, n_patches: int):
    """dL/dF of one patch, (B, C), from each image's class score ``fids``
    (B, C): ``one_vs_all_loss``'s BCE derivative with its 1/(B*C) mean and
    the patch mean's 1/Np, zero where ``bce_loss``'s clamp to [eps, 1 - eps]
    holds the score, as autograd's is there (a NaN score keeps its NaN)."""
    outside = (fids < fid._EPS) | (fids > 1.0 - fid._EPS)
    chain = torch.where(outside, 0.0, fid.bce_grad_wrt_fidelity(fids, onehot))
    return chain / (fids.numel() * n_patches)


def grad_shift(
    cfg: QuClassiConfig,
    params: dict,
    images,
    labels,
    executor: shift_rule.Executor | None = None,
    implicit: bool | None = None,
):
    """Paper-faithful distributed gradient: execute per-class circuit banks
    and assemble theta gradients.

    ``implicit``: route through implicit ``ShiftBank``s (None = auto: exactly
    when the executor declares the ``shiftbank`` capability).

    Dense-layer params, when present, are trained with exact chain-rule
    gradients holding theta fixed, on one of three routes
    (``dense_grad.route_plan``, decided once a configuration):

    * "register" (registers of up to m = 12 qubits): dF/dx analytically on
      the two m-qubit registers (F = |<phi(x)|psi(theta)>|^2, phi a
      product state), chained through the loss's weights at the bank's
      class scores (``dense_chain_weights``) and the sigmoid, and summed
      into w and b in a fixed order: ``dense_grad_kernel`` and its
      reduction on the card, their plain versions on the CPU.  Two calls
      give the same bits.
    * "wide" (m = 13-16): the same
      on the registers, with each class's psi built once a call in device
      memory and a block of the card a patch (``dense_wide_psi_kernel``,
      ``dense_wide_kernel``, then the same reduction); on the CPU the same
      plain versions.  No 2**qc-amplitude state is made.
    * "simulator" (m >= 17, or at m <= 12 every class's psi too wide for
      a block): autograd through ``class_fidelities`` and the dense
      simulator, as the reference uses ``jax.grad``.

    Spans (``repro_torch.obs.span``, recorded while a recorder is
    installed): ``grad_shift`` around the call; inside it
    ``grad_shift.bank_build``, per class ``grad_shift.execute`` (the
    executor) and ``grad_shift.assemble`` (the chain rule), and
    ``grad_shift.dense`` (arg ``route``) with ``.forward`` (the chain
    weights and the register kernel, or the chain weights, psi's build and
    the wide kernel, or the simulator's fidelities and the loss) and
    ``.backward`` (the partials' reduction into w and b, or
    ``torch.autograd.grad`` and the graph's teardown).
    """
    b, np_ = images.shape[0], cfg.n_patches
    with obs.span("grad_shift", batch=b, classes=cfg.n_classes,
                  circuits=total_bank_circuits(cfg, b)):
        run = executor or shift_rule.default_executor(cfg.spec)
        if implicit is None:
            implicit = capabilities_of(run).shiftbank
        with obs.span("grad_shift.bank_build"), torch.no_grad():
            angles, patches = encode_images(cfg, params, images)
            banks = _banks_of(params, angles, cfg.n_classes, implicit)
        onehot = F.one_hot(labels.long(), cfg.n_classes).to(torch.float32)

        theta_grads, losses, fids_per_class = [], [], []
        for c, bank in enumerate(banks):
            with obs.span("grad_shift.execute", **{"class": c}):
                fids = shift_rule.run_bank(run, bank)
            with obs.span("grad_shift.assemble", **{"class": c}):
                f0, f_plus, f_minus = bank.split_results(fids)[:3]
                # class score per image = mean patch fidelity; chain BCE
                # through the per-image MEAN, then distribute to the
                # per-patch estimates.
                f_img = f0.reshape(b, np_).mean(-1)                       # (B,)
                dfdt = (f_plus - f_minus) / 2.0                           # (P, B*Np)
                df_img = dfdt.reshape(-1, b, np_).mean(-1)                # (P, B)
                chain = fid.bce_grad_wrt_fidelity(f_img, onehot[:, c])    # (B,)
                # 1/(B*C) normalization to match one_vs_all_loss's mean over (B, C)
                theta_grads.append((df_img * chain[None, :]).mean(-1) / cfg.n_classes)
                losses.append(fid.bce_loss(f_img, onehot[:, c]).mean())
                fids_per_class.append(f_img)

        grads = {"theta": torch.stack(theta_grads)}
        fids = torch.stack(fids_per_class, -1)                            # (B, C)
        if cfg.use_dense:
            plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
            route = "simulator" if plan is None else "wide" if plan.wide else "register"
            with obs.span("grad_shift.dense", route=route):
                if plan is None:
                    grads.update(_dense_grad_simulator(cfg, params, images, labels))
                else:
                    with obs.span("grad_shift.dense.forward"), torch.no_grad():
                        weights = dense_chain_weights(fids, onehot, np_)
                        partials = dense_grad.register_partials(
                            plan, params["theta"], angles, patches, weights, np_)
                    with obs.span("grad_shift.dense.backward"):
                        gw, gb = dense_grad.reduce_partials(partials, cfg.patch_dim, cfg.n_angles)
                    grads.update(w=gw, b=gb)
        return torch.stack(losses).mean(), grads, fids


def _dense_grad_simulator(cfg: QuClassiConfig, params: dict, images, labels) -> dict:
    """The dense layer's gradient by autograd through ``class_fidelities``
    (the whole SWAP-test circuit on the dense simulator), theta held."""
    wb = {k: params[k].detach().requires_grad_(True) for k in ("w", "b")}
    with obs.span("grad_shift.dense.forward"):
        dense_loss = one_vs_all_loss(class_fidelities(cfg, dict(params, **wb), images), labels)
    with obs.span("grad_shift.dense.backward"):
        dense = torch.autograd.grad(dense_loss, [wb["w"], wb["b"]])
        del dense_loss   # the graph's teardown belongs to the backward
    return {"w": dense[0], "b": dense[1]}


def total_bank_circuits(cfg: QuClassiConfig, batch: int) -> int:
    """Circuits per gradient step — the workload the co-Manager schedules."""
    per_class = batch * cfg.n_patches * (2 * cfg.n_theta + 1)
    return cfg.n_classes * per_class
