"""How ``ring_fused_step``'s wrapper lays a hop out for its kernel, on the CPU.

``kernels.ring_fused_step.plan`` maps an ``acc`` and a ``wire`` (shape and
element strides) to the kernel's route and arguments, or to a copy. Three
things are held here, all in process and without a card:

- every ``acc`` that the S3 ring on a ``ProcessMesh`` hands the kernel is a
  view of the chunked gradient and plans without a copy: the views are cut
  by the port's own ``scatter_gradient`` over every FSDP and TP dim of the
  smoke qwen1.5, mamba2 and recurrentgemma leaves, on a one-process stand-in
  of the mesh whose ``ppermute`` hands back what it sends (a ring's real
  hops run in ``tests/test_torch_procs_train.py``'s ranks), and through
  ``fsdp_aggregate``'s and ``rep_aggregate``'s chunking on world dims;
- the plan's indexing, emulated with ``torch.as_strided`` (the kernel's
  reads of ``acc`` and ``wire`` at their strides, its writes at the
  outputs' pitches into NaN-filled buffers), gives bitwise what
  ``ref.ring_fused_step`` gives, on the edge layouts of ``chip_smoke.py``'s
  sweep and on every view above;
- ``ProcessMesh.dynamic_index_in_dim`` with a host index is a view that
  counts the index as ``lax`` does, equal to the world-dim gather.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402
from unittest import mock  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import collectives as coll  # noqa: E402
from repro_torch.core.scenarios import Scenario  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.mesh import Mesh, ProcessMesh  # noqa: E402
from repro_torch.models import parallel  # noqa: E402
from repro_torch.models.convert import leaf_paths  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.parallel import ShardEnv  # noqa: E402
from repro_torch.models.specs import layer_leaf, leaf_places  # noqa: E402

rfs = importlib.import_module("repro_torch.kernels.ring_fused_step")

ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b", "recurrentgemma-2b")
RINGS = (2, 4)  # FSDP ring sizes; the TP rings run over rep groups of 2


class OneRank(ProcessMesh):
    """A ``ProcessMesh`` of ``shape`` seen from the device at ``coords``,
    with no process group: its ``ppermute`` hands back a contiguous copy of
    what it sends, as a received buffer lands."""

    def __init__(self, axis_names, shape, coords):
        Mesh.__init__(self, axis_names, shape, device="cpu")
        self.coords = tuple(coords)
        self.rank = int(np.ravel_multi_index(self.coords, self.shape))
        self.block = (1,) * self.ndim
        self.staged = False

    def ppermute(self, x, axis, perm):
        return x.clone(memory_format=torch.contiguous_format)


def leaves(arch: str) -> dict:
    """{JAX leaf key: (shape, LeafPlace)} of the smoke model's parameters,
    one per key (the layers share their keys' shapes)."""
    model = Model(get_smoke_config(arch), device="meta")
    places, paths = leaf_places(model), leaf_paths(model)
    shapes = dict(model.named_parameters())
    out = {}
    for name, place in places.items():
        out.setdefault(layer_leaf(paths[name][0]), (tuple(shapes[name].shape), place))
    return out


LEAVES = [(arch, key) for arch in ARCHS for key in sorted(leaves(arch))]


def gradients(shape, seed: int):
    """A seeded fp32 gradient of ``shape``, row-major, and the same values
    laid out in reversed dim order (as autograd hands back the gradient of
    a weight used transposed)."""
    g = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    flipped = g.permute(*reversed(range(g.dim()))).contiguous()
    return {"row_major": g, "reversed": flipped.permute(*reversed(range(g.dim())))}


def emulated(acc: torch.Tensor, wire: torch.Tensor):
    """The kernel's reads and writes as the wrapper plans them (copies
    included): ``acc`` and ``wire`` read through ``torch.as_strided`` at the
    plan's strides from their own storage offsets, the results written at
    the outputs' pitches into NaN-filled buffers of the logical shape."""
    a, w, p, _ = rfs._planned(acc, wire)
    assert p.route in rfs.ROUTES
    av = torch.as_strided(a, p.dims, p.acc, a.storage_offset())
    wv = torch.as_strided(w, p.dims, p.wire, w.storage_offset())
    new_acc = torch.full((acc.numel(),), float("nan"))
    new_wire = torch.full((acc.numel(),), float("nan"), dtype=torch.bfloat16)
    s_acc, s_wire = ref.ring_fused_step(av, wv)
    torch.as_strided(new_acc, p.dims, p.out).copy_(s_acc)
    torch.as_strided(new_wire, p.dims, p.out).copy_(s_wire)
    return new_acc.view(acc.shape), new_wire.view(acc.shape)


def assert_bitwise_plain(acc, wire):
    got, want = emulated(acc, wire), ref.ring_fused_step(acc, wire)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32 if g.dtype == torch.float32 else torch.int16),
                           w.contiguous().view(torch.int32 if w.dtype == torch.float32
                                               else torch.int16))


def recording():
    """Patches that run the S3 ring with the plain hop and record, for each
    hop, its ``acc`` and ``wire`` and the chunked tensor its ring got."""
    hops, rings = [], []
    real_ring = coll.ring_reduce_scatter

    def ring(x, *args, **kw):
        rings.append(x)
        return real_ring(x, *args, **kw)

    def hop(acc, wire):
        hops.append((acc, wire, rings[-1]))
        return ref.ring_fused_step(acc, wire)

    return hops, (mock.patch.object(coll, "ring_reduce_scatter", ring),
                  mock.patch.object(ops, "ring_fused_step", hop))


def shares_storage(view: torch.Tensor, base: torch.Tensor) -> bool:
    return view.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()


def process_hops(shape, place, seed: int) -> list:
    """Every hop's (acc, wire, chunked tensor) of ``scatter_gradient`` under
    S3 for a leaf of ``shape`` on one-process stand-ins: its FSDP dim over a
    data ring of each of ``RINGS`` (device 1 of it), its TP dim over the
    model axis's rep groups of 2 (tp 2, rep 2; device 3, the second of its
    group), each from both gradient layouts."""
    out = []
    for layout, g in gradients(shape, seed).items():
        cases = []  # (env, axes, dim, groups, ring size)
        if place.fsdp_dim is not None:
            for p in RINGS:
                if shape[place.fsdp_dim] % p == 0:
                    pm = OneRank(("data", "model"), (p, 1), (1, 0))
                    env = ShardEnv(1, p, scenario=Scenario.S3_IN_NET_MAP, mesh=pm)
                    cases.append((env, env.fsdp_axes, place.fsdp_dim, None, p))
        if place.tp_dim is not None and shape[place.tp_dim] % 2 == 0:
            pm = OneRank(("data", "model"), (1, 4), (0, 3))
            env = ShardEnv(4, 1, tp=2, scenario=Scenario.S3_IN_NET_MAP, mesh=pm)
            cases.append((env, env.model_axis, place.tp_dim, env.rep_groups, 2))
        for env, axes, dim, groups, p in cases:
            hops, patches = recording()
            with patches[0], patches[1]:
                red = parallel.scatter_gradient(g, env, axes, dim, groups)
            assert red.shape == shape[:dim] + (shape[dim] // p,) + shape[dim + 1:]
            assert len(hops) == p - 1
            out += [(layout, dim, *h) for h in hops]
    return out


@pytest.mark.parametrize("arch,key", LEAVES)
def test_process_mesh_hops_read_the_chunked_gradient_in_place(arch, key):
    """Each hop's ``acc`` on a process mesh shares storage with its ring's
    chunked gradient and plans on a kernel route, no copy; its planned
    indexing gives the plain hop bitwise."""
    shape, place = leaves(arch)[key]
    hops = process_hops(shape, place, seed=len(LEAVES))
    if place.fsdp_dim is None and place.tp_dim is None:
        assert hops == []  # summed over the world, no ring
        return
    for layout, dim, acc, wire, chunked in hops:
        what = f"{arch} {key} {shape} ({layout}) along dim {dim}: acc {tuple(acc.shape)} " \
               f"strides {acc.stride()}"
        assert shares_storage(acc, chunked), what
        assert rfs.plan(acc.shape, acc.stride(), wire.stride()).route != "copy", what
        assert_bitwise_plain(acc, wire)


def test_process_mesh_hops_cover_both_routes():
    """Over the smoke leaves the process-mesh hops take both kernel routes:
    row-major chunks (a leaf cut along its first dim) and transposed ones
    (cut along a later dim)."""
    routes = set()
    for arch, key in LEAVES:
        shape, place = leaves(arch)[key]
        for _, _, acc, wire, _ in process_hops(shape, place, seed=0):
            routes.add(rfs.plan(acc.shape, acc.stride(), wire.stride()).route)
    assert routes == {"rows", "tiles"}


@pytest.mark.parametrize("aggregate", ["fsdp", "rep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_world_dim_chunks_plan_and_emulate_bitwise(arch, aggregate):
    """``fsdp_aggregate``'s and ``rep_aggregate``'s chunks on world dims (a
    data world of 4; a model axis of tp 2 × rep 2) under S3, every leaf of
    the smoke model with the dim the aggregation cuts: each hop's planned
    indexing is the plain hop bitwise (the world-dim gather's layouts are
    reported on the card, not changed)."""
    mesh = Mesh(("data",), (4,), device="cpu") if aggregate == "fsdp" else \
        Mesh(("data", "model"), (1, 2), device="cpu")
    for key, (shape, place) in leaves(arch).items():
        dim = place.fsdp_dim if aggregate == "fsdp" else place.tp_dim
        if dim is None or shape[dim] % 4:  # the world, or tp × rep
            continue
        g = torch.from_numpy(np.random.RandomState(7).randn(*mesh.shape, *shape)
                             .astype(np.float32))
        hops, patches = recording()
        with patches[0], patches[1]:
            if aggregate == "fsdp":
                parallel.fsdp_aggregate(g, mesh, dim, Scenario.S3_IN_NET_MAP)
            else:
                parallel.rep_aggregate(g, mesh, dim, 2, Scenario.S3_IN_NET_MAP)
        assert hops, key
        for acc, wire, _ in hops:
            assert_bitwise_plain(acc, wire)


def edge_layouts():
    """name → (acc, wire, route): the layouts of ``chip_smoke.py``'s sweep at
    CPU sizes, the route each must plan."""
    rs = np.random.RandomState(5)

    def f32(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32))

    def bf16(*shape):
        return f32(*shape).to(torch.bfloat16)

    wide = f32(40, 24)  # a (d, x) gradient; its chunks along d are (x, d/p) views
    out = {
        "flat": (f32(1001), bf16(1001), "rows"),
        "flat_unaligned": (f32(1002)[1:], bf16(1001), "rows"),
        "row_major": (f32(33, 70), bf16(33, 70), "rows"),
        "dense_transposed": (f32(70, 33).t(), bf16(33, 70), "tiles"),
        "transposed_chunk_of_wider": (wide.t().reshape(24, 4, 10).permute(1, 2, 0)[2].t(),
                                      bf16(24, 10), "tiles"),
        "row_strided_batches": (f32(3, 5, 40)[:, :, 4:36].reshape(3, 5, 32)[:, 1:4],
                                bf16(3, 3, 32), "rows"),
        "rep_chunks": (f32(2, 6, 9).reshape(2, 2, 3, 9).select(1, 1), bf16(2, 3, 9), "rows"),
        "batched_transposed": (f32(3, 37, 45).transpose(1, 2), bf16(3, 45, 37), "tiles"),
        "ragged_tiles": (f32(65, 31).t(), bf16(31, 65), "tiles"),
        "one_by_n": (f32(1, 77), bf16(1, 77), "rows"),
        "n_by_one": (f32(77, 1), bf16(77, 1), "rows"),
        "one_by_n_transposed": (f32(77, 1).t(), bf16(1, 77), "rows"),
        "n_by_one_transposed": (f32(1, 77).t(), bf16(77, 1), "rows"),
        "strided_slice": (f32(12, 20)[:, ::2], bf16(12, 10), "copy"),
        "transposed_wire": (f32(9, 11), bf16(11, 9).t(), "copy"),
        "scalar": (f32(1).reshape(()), bf16(1).reshape(()), "rows"),
    }
    return out


@pytest.mark.parametrize("name", sorted(edge_layouts()))
def test_edge_layouts_plan_their_route_and_emulate_bitwise(name):
    acc, wire, route = edge_layouts()[name]
    assert rfs.plan(acc.shape, acc.stride(), wire.stride()).route == route
    assert_bitwise_plain(acc, wire)


@pytest.mark.parametrize("name,copies", [("strided_slice", 1), ("transposed_wire", 1),
                                         ("dense_transposed", 0), ("flat_unaligned", 0)])
def test_only_a_layout_no_route_reads_is_copied_and_counted(name, copies):
    """The wrapper copies only what no route reads, the offending tensor
    first (a transposed ``wire`` alone: one copy, then the tiles route),
    each copy counted in ``COPIES``; ``reset_launches`` zeroes it."""
    acc, wire, _ = edge_layouts()[name]
    ops.reset_launches()
    a, w, p, _ = rfs._planned(acc, wire)
    assert ops.COPIES["ring_fused_step"] == copies and p.route in rfs.ROUTES
    assert (a is acc) == (name != "strided_slice")
    ops.reset_launches()
    assert ops.COPIES["ring_fused_step"] == 0


@pytest.mark.parametrize("index", [-9, -5, -1, 0, 2, 4, 5, 40])
def test_process_mesh_host_index_is_a_view_counted_as_lax_counts_it(index):
    """A host index on a ``ProcessMesh`` gives a view of the slice: a
    negative index from the end, then clamped, as the world-dim gather."""
    x = torch.arange(5 * 6, dtype=torch.float32).reshape(1, 5, 6)
    pm = OneRank(("data",), (8,), (3,))
    got = pm.dynamic_index_in_dim(x, index)
    want = Mesh(("data",), (1,), device="cpu").dynamic_index_in_dim(x, index)
    assert shares_storage(got, x) and torch.equal(got, want)
    tensor_index = pm.dynamic_index_in_dim(x, torch.full((1,), index))
    assert torch.equal(tensor_index, want)
