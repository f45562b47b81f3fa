"""The launchers' meshes on one card: the port of ``repro/launch/mesh.py``.

A shape is the reference's: (data, model) or (pod, data, model), and the
mesh is the world dims of a ``repro_torch.mesh.Mesh`` on one device, the
model axis included: serving and training run the model's tp ranks folded
over it (``launch.steps.make_env``), training its data-parallel ranks over
the data extent (``data_extent``) and the rep groups. One process per mesh
device (``mesh.ProcessMesh``) is ``launch.procs``'s.
"""
from __future__ import annotations

from repro_torch.mesh import Mesh

AXES = ("pod", "data", "model")


def make_mesh(shape, axes=None, *, device=None) -> Mesh:
    """A mesh of ``shape`` with ``axes`` (default: the last ``len(shape)`` of
    ("pod", "data", "model")) on ``device`` (``None``: the card)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh is data,model or pod,data,model, got {shape}")
    axes = tuple(axes) if axes is not None else AXES[-len(shape):]
    if axes != AXES[-len(shape):]:
        raise ValueError(f"mesh axes {axes}: the port takes {AXES[-len(shape):]}")
    return Mesh(axes, shape, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh as world dims on one card: data 16 ×
    model 16, or pod 2 × data 16 × model 16 with ``multi_pod`` (the
    reference's 16 × 16 TPU chips, 2 × 16 × 16 across two pods)."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16), device=device)


def data_extent(mesh: Mesh) -> Mesh:
    """``mesh``'s axes before its model axis (all of them without one), on
    its device: training's FSDP world, whose ranks each hold the model
    axis's rep groups too (``TrainStep.grad_mesh``)."""
    if "model" not in mesh.axis_names:
        return mesh
    m = mesh.dim("model")
    return Mesh(mesh.axis_names[:m], mesh.shape[:m], device=mesh.device)


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    """{axis: size} of a launcher's mesh."""
    return dict(zip(mesh.axis_names, mesh.shape))
