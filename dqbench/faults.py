"""The control and the planted faults that the comparison has to catch.

``control(cell)`` is a step to put in the program's place: the plain
reference computed in the precision below the one the configuration
states (float32 with every contraction's operands rounded to TF32).  Each
fault is a context manager that breaks the program's timed path
underneath the harness, through the module attributes it calls:

* ``unchanged``: the optimizer's update leaves the parameters as they were;
* ``half_batch``: the gradient is taken over the first half of the batch,
  the mean over that half;
* ``altered_answer``: each share of a bank that a worker's kernel returns
  has its second group's fidelities replaced by its first group's (a
  result written to the wrong row).

The cell runs on one chip, so no exchange between chips can be left out.
``calibrate.py`` reads them on the card; ``tests/`` on the CPU.
"""
from __future__ import annotations

import contextlib

import torch

import ref_quclassi


def control(cell):
    model, lr = cell.model, cell.params["lr"]
    prec = ref_quclassi.Precision(torch.float32, tf32=True)

    def step(trainer, images, labels):
        images, labels = trainer.to_device(images, labels)
        loss, grads = ref_quclassi.gradient(model, trainer.params, images, labels, prec)
        trainer.params = ref_quclassi.sgd(trainer.params, grads, lr)
        return float(loss), grads

    return step


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged():
    from repro_torch.optim import optimizers
    return _patched(optimizers, "apply_updates", lambda orig: lambda params, updates: params)


def half_batch():
    from repro_torch.core import quclassi

    def make(orig):
        def grad_shift(cfg, params, images, labels, **kw):
            h = images.shape[0] // 2
            return orig(cfg, params, images[:h], labels[:h], **kw)
        return grad_shift
    return _patched(quclassi, "grad_shift", make)


def altered_answer():
    from repro_torch.kernels import ops

    def make(orig):
        def shiftgroups(*args, **kw):
            out = orig(*args, **kw).clone()
            if out.shape[0] > 1:
                out[1] = out[0]
            return out
        return shiftgroups
    return _patched(ops, "vqc_fidelity_shiftgroups", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_answer": altered_answer}
