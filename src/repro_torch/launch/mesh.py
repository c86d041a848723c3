"""Device meshes of the port — counterpart of ``repro.launch.mesh``.

The port has no GSPMD and no collective library: a :class:`Mesh` is an
ordered grid of ``torch.device`` s with named axes, ``("data", "model")``,
held by one process.  ``launch.rnn_shardings`` runs each data-axis entry's
block of batch rows on that entry's device and each model-axis entry's
slice of the hidden units on its own, and puts the pieces back together on
the mesh's first device.

A grid may list one device more than once: on the CPU that is the
counterpart of the reference's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``), and on one card
it runs every shard's launches on that card, which proves the partition
and its cost where the machine holds a single GPU.

Importing this module touches no device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device


class Mesh:
    """An ordered grid of devices with named axes.

    Args:
      devices: the devices, any nesting; reshaped to ``shape``.
      axis_names: one name an axis of ``shape``.
      shape: the grid's shape (default: one axis over every device).

    ``devices`` keeps the reference's form (an array of the grid's shape,
    ``mesh.devices.shape``); :attr:`device_list` is the grid flattened in
    order and :attr:`home` its first device, where sharded results are put
    back together.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data",),
                 shape: Sequence[int] | None = None):
        flat = [torch.device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        shape = (len(flat),) if shape is None else tuple(int(n)
                                                         for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} names {len(axis_names)} "
                             f"axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if int(np.prod(shape)) != len(flat):
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(flat)} devices")
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.devices = grid.reshape(shape)
        self.axis_names = axis_names
        # (id(tensor), device, slice, precision) -> (tensor, version, copy):
        # weights placed on a shard device, kept until the tensor changes
        # (launch.rnn_shardings._placed).
        self._placed: dict = {}

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def device_list(self) -> list[torch.device]:
        return list(self.devices.reshape(-1))

    @property
    def home(self) -> torch.device:
        return self.devices.reshape(-1)[0]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        names = ", ".join(f"{a}={n}" for a, n in zip(self.axis_names,
                                                     self.shape))
        devs = sorted({str(d) for d in self.device_list})
        return f"Mesh({names}; {', '.join(devs)})"


#: The abstract device the production meshes list: the planning stack
#: (``launch.specs``, ``launch.dryrun``) builds its programs on fake
#: tensors and never places a tensor on a mesh entry.
ABSTRACT_DEVICE = torch.device("meta")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod meshes: 16 × 16 = 256 entries over
    ``("data", "model")``, or 2 × 16 × 16 = 512 over ``("pod", "data",
    "model")`` ("pod" is the slow dimension; only data parallelism, the
    gradient reduce, crosses it).  Every entry is :data:`ABSTRACT_DEVICE`:
    the port plans for 256 or 512 cards on a machine with one or none,
    as the reference lowers for them on forced host devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return Mesh([ABSTRACT_DEVICE] * n, axes, shape)


def make_host_mesh(*, device="cpu") -> Mesh:
    """One-device mesh with the production axis names (CPU tests, smoke
    runs)."""
    return Mesh([resolve_device(device)], ("data", "model"), (1, 1))


def make_data_mesh(n_data: int, *, model: int = 1, device=None,
                   devices: Sequence | None = None) -> Mesh:
    """A ``(data, model)`` mesh of ``n_data × model`` devices.

    * ``devices``: the grid's devices in order (data-major); a device may
      repeat.  Its length must be ``n_data × model``.
    * otherwise ``device`` (default CUDA) picks the kind: ``"cpu"`` lists
      the CPU ``n_data × model`` times; CUDA takes that many visible
      cards, from the index given (0 when none), and raises when the
      machine has fewer.  A mesh never shrinks to what there is.
    """
    need = int(n_data) * int(model)
    if need < 1:
        raise ValueError(f"mesh ({n_data}, {model}) needs at least one "
                         "device")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != need:
            raise ValueError(f"mesh ({n_data}, {model}) needs {need} "
                             f"devices, got a list of {len(devs)}")
    else:
        dev = resolve_device(device)
        if dev.type == "cpu":
            devs = [dev] * need
        else:
            first, have = dev.index, torch.cuda.device_count()
            if first + need > have:
                raise ValueError(
                    f"mesh ({n_data}, {model}) needs {need} devices from "
                    f"cuda:{first}, host has {have}")
            devs = [torch.device("cuda", first + k) for k in range(need)]
    return Mesh(devs, ("data", "model"), (int(n_data), int(model)))


def data_mesh_like(n_data: int, *, mesh: Mesh | None = None,
                   device=None) -> Mesh:
    """A data mesh of ``n_data`` entries over the devices an engine serves
    on: a ``mesh`` that names one device lists it ``n_data`` times; any
    other mesh, or ``device`` when there is no mesh, gives
    :func:`make_data_mesh`'s devices from its first one on (the CPU
    repeated; that many cards, or an error)."""
    if mesh is not None:
        distinct = list(dict.fromkeys(mesh.device_list))
        if len(distinct) == 1:
            return make_data_mesh(n_data, devices=distinct * int(n_data))
        device = mesh.home
    return make_data_mesh(n_data, device=device)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism (pod joins data when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
