"""Mesh construction (the JAX package's ``repro.launch.mesh``).

The production meshes are *logical*: the reference's 16 x 16 pod and 2 x
16 x 16 pods, axis names and sizes with no devices, which the rules use
to account what each device of such a pod would hold.  The host mesh
covers the cards present (or the CPU, when asked for), and the stage mesh
puts every stage of a pipeline on one device.  Functions, not module
constants, so importing touches no device.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod mesh, logical: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def _devices(device) -> list:
    from repro_torch.explore.runner import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_host_mesh(model: Optional[int] = None, device="cuda") -> Mesh:
    """(data, model) mesh over every card present (``model`` of them on
    the model axis), or over the one device ``device`` names when it is
    not a CUDA device (``"cpu"`` in the tests)."""
    devices = _devices(device)
    n, m = len(devices), model or 1
    if n % m:
        raise ValueError(f"{n} devices do not split into model axis {m}")
    return Mesh(("data", "model"), (n // m, m), tuple(devices))


def make_stage_mesh(n_stages: int, device="cuda") -> Mesh:
    """(pod, data, model) mesh of ``n_stages`` pipeline stages, data and
    model 1, every stage on the one device ``device`` names (``cuda`` is
    the first card)."""
    dev = _devices(device)[0]
    return Mesh(("pod", "data", "model"), (n_stages, 1, 1),
                (dev,) * n_stages)
