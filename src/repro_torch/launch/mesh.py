"""The launchers' meshes on one card: the port of ``repro/launch/mesh.py``.

A shape is the reference's: (data, model) or (pod, data, model). The data
world, the axes before the model axis, becomes the world dims of a
``repro_torch.mesh.Mesh`` on one device; the model axis must be 1, since
tensor parallelism needs more than one card.
"""
from __future__ import annotations

from repro_torch.mesh import Mesh

AXES = ("pod", "data", "model")


def make_mesh(shape, axes=None, *, device=None) -> Mesh:
    """A mesh of ``shape`` with ``axes`` (default: the last ``len(shape)`` of
    ("pod", "data", "model")) → the data world's ``Mesh`` on ``device``
    (``None``: the card). Raises on a model axis above 1."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh is data,model or pod,data,model, got {shape}")
    axes = tuple(axes) if axes is not None else AXES[-len(shape):]
    if axes != AXES[-len(shape):]:
        raise ValueError(f"mesh axes {axes}: the port takes {AXES[-len(shape):]}")
    if shape[-1] != 1:
        raise ValueError(f"model axis {shape[-1]}: tensor parallelism needs more than one card "
                         "and is not ported; use a model axis of 1")
    return Mesh(axes[:-1], shape[:-1], device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The data extent of the reference's production mesh on one card: data
    16, or pod 2 × data 16 with ``multi_pod``, and the model axis at 1. The
    reference's mesh is 16 × 16 TPU chips (2 × 16 × 16 across two pods) with
    tp 16 along the model axis; tp 16 across a pod waits for more than one
    card."""
    return make_mesh((2, 16, 1) if multi_pod else (16, 1), device=device)


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    """{axis: size} of a launcher's mesh, its model axis of 1 included."""
    return {**dict(zip(mesh.axis_names, mesh.shape)), "model": 1}
