"""Device meshes of the port: a tuple of ``torch.device``s on one ``data``
axis, inside one process.

The reference is single-controller: ``shard_map`` over the ``data`` axis of
the local devices.  Its counterpart here launches every shard on its own
device from the one process (``repro_torch.comanager.dataplane.
sharded_executor``); no process group is involved.  Defined as functions, so
importing this module touches no device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """Local devices on named axes; the port uses the ``data`` axis only
    (``model`` is 1, kept so ``shape`` reads like the reference's mesh)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's TPU pod mesh (16 x 16 chips, 2 pods multi-pod), read
    only by the dry-runs."""
    raise NotImplementedError(
        "the production mesh is read only by the dry-runs, which are not "
        "ported yet (ROADMAP Queue 1 item 15)"
    )


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_axis_size(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def make_host_mesh(device="cuda") -> DeviceMesh:
    """A one-device mesh on ``device`` (the first card by default; pass
    ``"cpu"`` for the plain path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return DeviceMesh((dev,))


def make_data_mesh(n_shards: int | None = None, device: str = "cuda") -> DeviceMesh:
    """All (or ``n_shards``) local CUDA devices on the ``data`` axis; with
    ``device="cpu"``, ``n_shards`` (default 1) entries of the CPU, which the
    tests use to run meshes of several shards without a card."""
    if device == "cpu":
        return DeviceMesh((torch.device("cpu"),) * (n_shards or 1))
    if not torch.cuda.is_available():
        raise RuntimeError("make_data_mesh: CUDA is not available (pass device='cpu')")
    avail = torch.cuda.device_count()
    n = n_shards or avail
    if n > avail:
        raise ValueError(f"{n} shards requested, {avail} CUDA devices visible")
    return DeviceMesh(tuple(torch.device("cuda", i) for i in range(n)))
