"""Device meshes of the port: a tuple of ``torch.device``s on one ``data``
axis, inside one process (``DeviceMesh``), and shape-only meshes that the
dry-runs partition against (``ShapeMesh``).

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


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of named axes and sizes with no devices behind it: what the
    dry-runs partition against (the counterpart of the reference's meshes
    of host placeholders).  Nothing is ever placed on it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(n < 1 for n in self.sizes):
            raise ValueError(f"bad mesh {self.axis_names} x {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_mesh(sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> ShapeMesh:
    return ShapeMesh(tuple(axis_names), tuple(sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's TPU pod mesh, shape only: 16 x 16 = 256 chips on
    ("data", "model"); 2 pods = 512 chips on ("pod", "data", "model")."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def chips(mesh) -> int:
    """Devices of ``mesh`` (a ``DeviceMesh`` or a ``ShapeMesh``)."""
    n = 1
    for size in mesh.shape.values():
        n *= size
    return n


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
