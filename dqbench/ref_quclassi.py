"""Plain reference of one QuClassi training step (DQuLearn Algorithm 1).

Written from the papers' description, in plain PyTorch, with nothing taken
from the program: its own circuit layout, segmentation, encoding, gate
matrices and statevector arithmetic.

A QuClassi circuit over ``qc = 2m + 1`` qubits encodes a patch on the data
register (RX, RY a qubit), prepares the trainable register with the
variational layers (single: RY, RZ a qubit; dual: RYY, RZZ on adjacent
pairs; entangle: CRY, CRZ on adjacent pairs), and reads the fidelity
``F = |<phi|psi>|^2`` of the two registers out with a SWAP test.  The
reference computes ``F`` from the two m-qubit register states, which is
the SWAP test's value (``swap_test_fidelity`` simulates the whole circuit
and a test holds the two together), so a 27-qubit circuit costs two
2**13-amplitude states and not one of 2**27.

A step: segment the images, encode each patch (``pi * sigmoid(patch @ w
+ b)`` with the dense layer, ``pi * pixel`` tiled or pooled without it),
evaluate every circuit of the parameter-shift bank (the base angles, then
each parameter shifted by +pi/2, then each by -pi/2), assemble the theta
gradient by the two-term rule through the per-image mean of the patch
fidelities and the one-vs-all binary cross-entropy, take the dense
layer's gradient exactly (autograd through the base circuits), and apply
SGD.  ``Precision(torch.float64)`` is the reference;
``Precision(torch.float32, tf32=True)`` rounds every operand of every
contraction to TF32's 10-bit mantissa, as a TF32 matrix unit reads it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

EPS = 1e-7  # the loss clamps the class score to [EPS, 1 - EPS]


@dataclasses.dataclass(frozen=True)
class Model:
    qc: int
    n_layers: int
    n_classes: int
    filter_width: int
    stride: int
    image_size: tuple[int, int]
    use_dense: bool

    @property
    def m(self) -> int:
        return (self.qc - 1) // 2

    @property
    def n_angles(self) -> int:
        return 2 * self.m

    @property
    def data_ops(self) -> list:
        """(gate, register-local qubits, angle index) of the encoding."""
        return [op for i in range(self.m)
                for op in (("rx", (i,), 2 * i), ("ry", (i,), 2 * i + 1))]

    @property
    def train_ops(self) -> list:
        """(gate, register-local qubits, theta index) of the variational
        layers, in circuit order."""
        ops, j, m = [], 0, self.m
        kinds = (("ry", "rz"), ("ryy", "rzz"), ("cry", "crz"))[: self.n_layers]
        for layer, (g1, g2) in enumerate(kinds):
            sites = [(i,) for i in range(m)] if layer == 0 else [
                (i, i + 1) for i in range(m - 1)]
            for qs in sites:
                ops += [(g1, qs, j), (g2, qs, j + 1)]
                j += 2
        return ops

    @property
    def n_theta(self) -> int:
        return len(self.train_ops)

    @property
    def n_patches(self) -> int:
        return math.prod(_grid(n, self.filter_width, self.stride) for n in self.image_size)


def model_from_config(cfg: dict) -> Model:
    return Model(qc=cfg["qc"], n_layers=cfg["n_layers"], n_classes=cfg["n_classes"],
                 filter_width=cfg["filter_width"], stride=cfg["stride"],
                 image_size=(cfg["image_height"], cfg["image_width"]),
                 use_dense=cfg["use_dense"])


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a TF32 unit reads it (round to nearest on the 10-bit
        mantissa), gradients passed straight through; ``x`` itself when
        ``tf32`` is off."""
        if not self.tf32:
            return x
        if x.is_complex():
            return torch.view_as_complex(self.rnd(torch.view_as_real(x.resolve_conj())))
        bits = x.detach().contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (r - x).detach()


# ----------------------------------------------------------- segmentation
def _grid(n: int, fw: int, stride: int) -> int:
    return max(1, -(-(n - fw) // stride) + 1)


def segment(images: torch.Tensor, fw: int, stride: int) -> torch.Tensor:
    """(B, H, W) -> (B, patches, fw * fw), row-major, the image zero-padded
    at the bottom and right so that the patches cover it."""
    b, h, w = images.shape
    gh, gw = _grid(h, fw, stride), _grid(w, fw, stride)
    x = torch.nn.functional.pad(images, (0, (gw - 1) * stride + fw - w,
                                         0, (gh - 1) * stride + fw - h))
    x = x.unfold(1, fw, stride).unfold(2, fw, stride)       # (B, gh, gw, fw, fw)
    return x.reshape(b, gh * gw, fw * fw)


def rotation_angles(patches: torch.Tensor, n: int) -> torch.Tensor:
    """pi * pixel, average-pooled to ``n`` values or tiled up to them."""
    p = patches.shape[-1]
    if p > n:
        v = torch.nn.functional.pad(patches, (0, (-p) % n))
        v = v.reshape(*patches.shape[:-1], n, -1).mean(-1)
    else:
        v = torch.cat([patches] * -(-n // p), -1)[..., :n]
    return v * math.pi


# ------------------------------------------------------------- statevector
def gate(name: str, angle: torch.Tensor, cdtype) -> torch.Tensor:
    """(N, 2**k, 2**k) complex matrices, one per angle; the first qubit of a
    two-qubit gate is the more significant bit of its index."""
    c = torch.cos(angle / 2).to(cdtype)
    s = torch.sin(angle / 2).to(cdtype)
    z, one, i = torch.zeros_like(c), torch.ones_like(c), 1j
    rows = {
        "rx": [[c, -i * s], [-i * s, c]],
        "ry": [[c, -s], [s, c]],
        "rz": [[c - i * s, z], [z, c + i * s]],
        "ryy": [[c, z, z, i * s], [z, c, -i * s, z], [z, -i * s, c, z], [i * s, z, z, c]],
        "rzz": [[c - i * s, z, z, z], [z, c + i * s, z, z], [z, z, c + i * s, z],
                [z, z, z, c - i * s]],
        "cry": [[one, z, z, z], [z, one, z, z], [z, z, c, -s], [z, z, s, c]],
        "crz": [[one, z, z, z], [z, one, z, z], [z, z, c - i * s, z], [z, z, z, c + i * s]],
    }[name]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


H = [[2**-0.5, 2**-0.5], [2**-0.5, -(2**-0.5)]]


def apply(state: torch.Tensor, u: torch.Tensor, qubits, n: int, prec: Precision):
    """Apply ``u`` ((2**k, 2**k) or one a state) to ``qubits`` of (N, 2**n)
    states; qubit 0 is the most significant bit of the index."""
    k, lead = len(qubits), list(range(1, len(qubits) + 1))
    t = state.reshape((state.shape[0],) + (2,) * n)
    t = torch.movedim(t, [1 + q for q in qubits], lead)
    shape = t.shape
    out = torch.matmul(prec.rnd(u), prec.rnd(t.reshape(shape[0], 2**k, -1)))
    out = torch.movedim(out.reshape(shape), lead, [1 + q for q in qubits])
    return out.reshape(state.shape)


def run_ops(ops, n: int, angles: torch.Tensor, prec: Precision) -> torch.Tensor:
    """(N, 2**n) states of ``ops`` from |0...0>, ``angles`` (N, A)."""
    state = torch.zeros((angles.shape[0], 2**n), dtype=prec.cdtype, device=angles.device)
    state[:, 0] = 1
    for name, qs, j in ops:
        state = apply(state, gate(name, angles[:, j], prec.cdtype), qs, n, prec)
    return state


def register_fidelity(phi: torch.Tensor, psi: torch.Tensor, prec: Precision):
    """(N, V) fidelities |<phi_n|psi_v>|^2 of (N, 2**m) and (V, 2**m) states."""
    inner = torch.matmul(prec.rnd(phi.conj()), prec.rnd(psi).T)
    return inner.real**2 + inner.imag**2


def swap_test_fidelity(model: Model, theta: torch.Tensor, angles: torch.Tensor,
                       prec: Precision) -> torch.Tensor:
    """F = 2 P(ancilla = 0) - 1 of the whole (2m + 1)-qubit SWAP-test
    circuit, (N,) for theta (N, P) and angles (N, A): only for small m."""
    m, n = model.m, model.qc
    ops = [(g, tuple(1 + q for q in qs), ("data", j)) for g, qs, j in model.data_ops]
    ops += [(g, tuple(1 + m + q for q in qs), ("theta", j)) for g, qs, j in model.train_ops]
    state = torch.zeros((angles.shape[0], 2**n), dtype=prec.cdtype, device=angles.device)
    state[:, 0] = 1
    for name, qs, (kind, j) in ops:
        a = (theta if kind == "theta" else angles)[:, j]
        state = apply(state, gate(name, a, prec.cdtype), qs, n, prec)
    h = torch.tensor(H, dtype=prec.cdtype, device=angles.device)
    swap = torch.eye(8, dtype=prec.cdtype, device=angles.device)[[0, 1, 2, 3, 4, 6, 5, 7]]
    state = apply(state, h, (0,), n, prec)
    for i in range(m):
        state = apply(state, swap, (0, 1 + i, 1 + m + i), n, prec)
    state = apply(state, h, (0,), n, prec)
    p0 = (state.abs() ** 2)[:, : 2 ** (n - 1)].sum(-1)
    return 2 * p0 - 1


# -------------------------------------------------------------------- step
def shifted(theta: torch.Tensor) -> torch.Tensor:
    """(1 + 2P, P): the base angles, each shifted by +pi/2, each by -pi/2."""
    eye = torch.eye(theta.shape[0], dtype=theta.dtype, device=theta.device)
    return torch.cat([theta[None], theta + math.pi / 2 * eye, theta - math.pi / 2 * eye])


def encode(model: Model, params: dict, patches: torch.Tensor, prec: Precision):
    if model.use_dense:
        z = torch.matmul(prec.rnd(patches), prec.rnd(params["w"])) + params["b"]
        return math.pi * torch.sigmoid(z)
    return rotation_angles(patches, model.n_angles)


def bce(f, y):
    f = torch.clamp(f, EPS, 1 - EPS)
    return -(y * torch.log(f) + (1 - y) * torch.log(1 - f))


def gradient(model: Model, params: dict, images, labels, prec: Precision):
    """-> (loss, grads): the loss of the base circuits, the two-term
    parameter-shift theta gradient, and the dense layer's exact gradient."""
    dt = prec.dtype
    leaves = {k: v.detach().to(dt).requires_grad_(k != "theta") for k, v in params.items()}
    patches = segment(images.to(dt), model.filter_width, model.stride)
    b, n_p = patches.shape[:2]
    angles = encode(model, leaves, patches, prec).reshape(b * n_p, model.n_angles)
    phi = run_ops(model.data_ops, model.m, angles, prec)
    p = model.n_theta
    losses, theta_grads = [], []
    for c in range(model.n_classes):
        y = (labels == c).to(dt)
        var = shifted(leaves["theta"][c])
        psi = run_ops(model.train_ops, model.m, var, prec)
        f = torch.clamp(register_fidelity(phi, psi, prec), 0.0, 1.0).reshape(b, n_p, -1)
        f_img = f[..., 0].mean(-1)
        dfdt = ((f[..., 1:1 + p] - f[..., 1 + p:]) / 2).mean(1).detach()     # (B, P)
        fc = torch.clamp(f_img.detach(), EPS, 1 - EPS)
        chain = (fc - y) / (fc * (1 - fc))
        theta_grads.append((dfdt * chain[:, None]).mean(0) / model.n_classes)
        losses.append(bce(f_img, y).mean())
    loss = torch.stack(losses).mean()
    grads = {"theta": torch.stack(theta_grads)}
    if model.use_dense:
        gw, gb = torch.autograd.grad(loss, [leaves["w"], leaves["b"]])
        grads.update(w=gw, b=gb)
    return loss.detach(), grads


def sgd(params: dict, grads: dict, lr: float) -> dict:
    return {k: (v - lr * grads[k]).to(v.dtype) for k, v in params.items()}


def follow(model: Model, params0: dict, batches, lr: float, prec: Precision):
    """The first steps of training from ``params0`` on ``batches`` (a list
    of (images, labels)): -> (losses, the first step's gradients, the
    parameters after the last step)."""
    params = {k: v.detach().to(prec.dtype) for k, v in params0.items()}
    losses, first = [], None
    for images, labels in batches:
        loss, grads = gradient(model, params, images, labels, prec)
        losses.append(float(loss))
        first = first if first is not None else grads
        params = sgd(params, grads, lr)
    return losses, first, params
