"""DQuLearn training loop — Algorithm 1's epoch loop, end to end.

Per epoch (lines 4-26): start timer -> segment data / encode -> build the
parameter-shift circuit bank -> execute every circuit in the bank through the
chosen executor (the statevector kernels, per worker through the data plane)
-> assemble gradients -> update parameters -> stop timer, record accuracy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import quclassi
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.data import pipeline
from repro_torch.optim import optimizers


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    loss: float
    train_accuracy: float
    test_accuracy: float
    wall_seconds: float
    circuits_executed: int


@dataclasses.dataclass
class TrainReport:
    epochs: list[EpochRecord]
    params: dict

    @property
    def final_test_accuracy(self) -> float:
        return self.epochs[-1].test_accuracy if self.epochs else 0.0


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA requested on a host without
    CUDA raises rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def train(
    cfg: QuClassiConfig,
    train_set,
    test_set,
    *,
    epochs: int = 10,
    batch_size: int = 8,
    lr: float = 1e-3,
    grad_mode: str = "shift",
    executor=None,
    optimizer: str = "sgd",
    gateway=None,
    client_id: str = "trainer",
    bank_mode: str = "auto",
    priority: int = 1,
    slo_ms: Optional[float] = None,
    policy=None,
    seed: int = 0,
    init_params: Optional[dict] = None,
    device="cuda",
    log: Optional[Callable[[str], None]] = None,
) -> TrainReport:
    """Train QuClassi per Algorithm 1 on ``device`` (the GPU by default;
    pass ``device="cpu"`` for the plain-PyTorch path).

    ``grad_mode``: 'shift' (paper-faithful circuit-bank path, optionally
    distributed via ``executor``) or 'autodiff' (exact local path).

    ``gateway``: a ``repro_torch.serve.GatewayRuntime``; the shift-rule
    circuit banks are then streamed through the online serving gateway as
    client ``client_id`` — coalesced (possibly with other tenants sharing
    the runtime) into shared kernel launches, placed by the co-Manager, and
    executed by the statevector kernels.  Fidelities come back in
    submission order, so gradient assembly is unchanged.  A runtime
    constructed with ``mode="async"`` rides the async path transparently:
    submissions stream into the pump loop while earlier batches execute on
    the worker pool (one CUDA stream per slot), and the per-bank gather
    blocks on out-of-order futures.

    ``priority`` / ``slo_ms`` (gateway mode): this client's strict
    scheduling tier (lower = served first) and end-to-end latency SLO,
    forwarded to ``Gateway.register_client``.  ``policy``: an object with
    ``priority``, ``slo_ms`` and ``weight`` (the reference's
    ``api.TenantPolicy``); when given it supersedes the loose kwargs.

    ``bank_mode``: 'materialized' (explicit (C, P) circuit banks),
    'implicit' (``ShiftBank``s, run by shift-aware executors through the
    prefix-reuse kernel; a gateway then carries per-(param, shift) group
    subtasks instead of per-row circuits), or 'auto' (implicit exactly when
    the executor declares the ``shiftbank`` capability).

    ``init_params``: starting weights as tensors (e.g. from
    ``quclassi.params_from_numpy``); by default they are drawn from a
    ``torch.Generator`` seeded with ``seed``.  ``seed`` also orders the
    batches.

    The port computes in strict float32, like the reference: TF32 is
    switched off for matrix products and convolutions.
    """
    if bank_mode not in ("auto", "implicit", "materialized"):
        raise ValueError(f"unknown bank_mode {bank_mode!r}")
    if policy is not None:
        priority, slo_ms = policy.priority, policy.slo_ms
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    implicit = {"auto": None, "implicit": True, "materialized": False}[bank_mode]
    if gateway is not None:
        if executor is not None:
            raise ValueError("pass either executor or gateway, not both")
        gw_opts = dict(priority=priority, slo_ms=slo_ms)
        if policy is not None:
            gw_opts["weight"] = policy.weight
        executor = (
            gateway.shift_executor(cfg.spec, client_id, **gw_opts)
            if bank_mode == "implicit"
            else gateway.executor(cfg.spec, client_id, **gw_opts)
        )
    (xtr, ytr), (xte, yte) = train_set, test_set
    xtr, xte = pipeline.clean(xtr), pipeline.clean(xte)
    if init_params is None:
        params = quclassi.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    else:
        params = {k: v.to(dev, torch.float32) for k, v in init_params.items()}
    opt = optimizers.make(optimizer, lr)
    opt_state = opt.init(params)
    records: list[EpochRecord] = []
    xtr_d, ytr_d = torch.as_tensor(xtr, device=dev), torch.as_tensor(ytr, device=dev)
    xte_d, yte_d = torch.as_tensor(xte, device=dev), torch.as_tensor(yte, device=dev)

    for epoch in range(epochs):                       # line 4
        t0 = time.perf_counter()                      # line 5: epoch timer
        losses, n_circ = [], 0
        for xb, yb in pipeline.batches(xtr, ytr, batch_size, seed=seed * 997 + epoch):
            xb, yb = torch.as_tensor(xb, device=dev), torch.as_tensor(yb, device=dev)
            if grad_mode == "shift":
                loss, grads, _ = quclassi.grad_shift(
                    cfg, params, xb, yb, executor=executor, implicit=implicit
                )
                n_circ += quclassi.total_bank_circuits(cfg, xb.shape[0])
            else:
                loss, grads, _ = quclassi.grad_autodiff(cfg, params, xb, yb)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optimizers.apply_updates(params, updates)
            losses.append(float(loss))  # waits for the step's device work
        wall = time.perf_counter() - t0               # lines 24-25
        with torch.no_grad():
            tr_acc = float(quclassi.accuracy(cfg, params, xtr_d, ytr_d))
            te_acc = float(quclassi.accuracy(cfg, params, xte_d, yte_d))
        rec = EpochRecord(epoch, float(np.mean(losses)), tr_acc, te_acc, wall, n_circ)
        records.append(rec)                           # line 26: accuracy/epoch
        if log:
            log(
                f"epoch {epoch}: loss={rec.loss:.4f} train_acc={tr_acc:.3f} "
                f"test_acc={te_acc:.3f} wall={wall:.2f}s circuits={n_circ}"
            )
    return TrainReport(records, params)
