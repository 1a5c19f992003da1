"""The system's example programs on the port, one module per script of the
reference's ``examples/`` under the same name:

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # the GPU
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu  # plain path

``quickstart``, ``distributed_training``, ``gateway_serving``,
``cluster_api``, ``failure_injection``, ``federated_dql`` and
``transformer_train`` run circuits or a model on ``--device``;
``multitenant_serving``, ``scale_storm`` and ``trace_demo`` run on the
virtual clock.  Each module's ``main(argv=None) -> dict`` takes the
reference script's flags plus ``--device`` (``cuda`` by default; asking for
CUDA on a host without it raises), prints the reference's lines, and
returns the numbers it prints and the arrays its checks need.  Where the
reference draws from ``jax.random``, the port draws from a seeded
``torch.Generator``, and the scene takes those draws as a keyword
(``theta=`` / ``params=`` / ``params0=``) so that a caller can hold it
against the reference on the same inputs.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.trainer import resolve_device


def arg_parser(doc: str | None) -> argparse.ArgumentParser:
    """The program's parser, with ``--device``."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where circuits and models run (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap


def parse(ap: argparse.ArgumentParser, argv) -> tuple[argparse.Namespace, torch.device]:
    """-> (arguments, device); CUDA requested without CUDA raises."""
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)
