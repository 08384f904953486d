"""Meshes over the visible cards, and the production pods' shapes.

Single pod: 16x16 = 256 devices, axes (data, model).
Multi-pod:  2x16x16 = 512 devices, axes (pod, data, model) — the pod axis
carries only the slow inter-pod gradient reductions.

A `Mesh` is a small dataclass: axis names and an object array of
``torch.device``s in the mesh's shape.  Nothing here touches a card
(``torch.device("cuda", i)`` is a name), so a device list can be passed
in to test the index arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_production_mesh", "make_abstract_mesh",
           "make_local_mesh", "make_mesh_with_layout", "batch_axes_of"]


@dataclass
class Mesh:
    axis_names: tuple[str, ...]
    devices: np.ndarray  # object array of torch.device, one axis per name

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _pod(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _visible(device) -> list[torch.device]:
    """Every card of ``device``'s type (the CPU counts as one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _grid(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: "str | torch.device" = "cuda") -> Mesh:
    """The (data, model) pod mesh, or (pod, data, model) over two pods, on
    the first 256 (512) cards; raises where fewer are visible."""
    shape, axes = _pod(multi_pod)
    n = int(np.prod(shape))
    devices = _visible(device)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices for {axes} {shape}, have "
                           f"{len(devices)}")
    return Mesh(axes, _grid(devices[:n], shape))


def make_abstract_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's axes and shape over placeholder ``meta``
    devices: what the planner reads, for planning a cell without its cards
    (`repro_torch.launch.dryrun`)."""
    shape, axes = _pod(multi_pod)
    return Mesh(axes, _grid([torch.device("meta")] * int(np.prod(shape)), shape))


def make_local_mesh(model_parallel: int = 1,
                    device: "str | torch.device" = "cuda") -> Mesh:
    """A (data, model) mesh over the visible cards (tests and examples)."""
    devices = _visible(device)
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices do not split into model_parallel="
                         f"{model_parallel}")
    return Mesh(("data", "model"), _grid(devices, (n // model_parallel,
                                                   model_parallel)))


def make_mesh_with_layout(device_order, *, multi_pod: bool = False,
                          devices=None,
                          device: "str | torch.device" = "cuda") -> Mesh:
    """Production mesh with a SNEAP-optimized logical->physical layout
    (`repro_torch.sharding.sneap_device_layout`): ``device_order[i]`` is
    the physical device that logical position i should occupy.
    ``devices`` (default: the visible cards of ``device``'s type) is the
    physical device list the order indexes."""
    shape, axes = _pod(multi_pod)
    devs = list(devices) if devices is not None else _visible(device)
    order = np.asarray(device_order)
    if order.size != int(np.prod(shape)) or order.max() >= len(devs):
        raise RuntimeError(f"need {int(np.prod(shape))} devices for {axes} "
                           f"{shape} (order max {int(order.max())}), have "
                           f"{len(devs)}")
    return Mesh(axes, _grid([devs[i] for i in order.reshape(-1)], shape))


def batch_axes_of(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")
