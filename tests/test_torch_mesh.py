"""The world-dim mesh (``repro_torch.mesh``) vs ``lax`` collectives.

One subprocess runs every ``lax`` op under ``shard_map`` on 8 fake CPU
devices (``(8,)`` and ``(2, 4)`` meshes) and writes the results to an
``.npz``; the port's ``Mesh`` on the CPU then computes the same from the
same numpy shards. Data is integer-valued, so sums match bitwise. Also:
the package imports neither ``jax`` nor ``repro``, and ``Mesh()`` with no
device refuses to run without CUDA.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.mesh import Mesh  # noqa: E402

X8 = np.random.RandomState(0).randint(-50, 50, (8, 8, 6)).astype(np.float32)
X24 = np.random.RandomState(1).randint(-50, 50, (2, 4, 4, 6)).astype(np.float32)
PARTIAL = [(0, 3), (2, 5), (7, 0)]
GROUPS = [[0, 1, 2, 3], [4, 5, 6, 7]]

JAX_SCRIPT = r"""
import sys, numpy as np, jax
from functools import partial
from jax import lax
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_mesh as T
m8 = jax.make_mesh((8,), ("all",), axis_types=(jax.sharding.AxisType.Auto,))
m24 = jax.make_mesh((2, 4), ("pod", "data"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
on8 = lambda f: jax.shard_map(lambda v: f(v[0])[None], mesh=m8, in_specs=P("all"), out_specs=P("all"))
on24 = lambda f: jax.shard_map(lambda v: f(v[0, 0])[None, None], mesh=m24,
                               in_specs=P("pod", "data"), out_specs=P("pod", "data"))
out = {{}}
ring = [(i, (i + 1) % 8) for i in range(8)]
out["ppermute_ring"] = on8(lambda v: lax.ppermute(v, "all", ring))(T.X8)
out["ppermute_partial"] = on8(lambda v: lax.ppermute(v, "all", T.PARTIAL))(T.X8)
out["a2a"] = on8(lambda v: lax.all_to_all(v, "all", 0, 0, tiled=False))(T.X8)
x = T.X8.reshape(8, 2, 8, 3)
out["a2a_split1"] = on8(lambda v: lax.all_to_all(v, "all", 1, 0, tiled=False))(x)
out["a2a_tiled"] = on8(lambda v: lax.all_to_all(v, "all", 0, 0, tiled=True))(T.X8.reshape(8, 16, 3))
out["a2a_tiled_c1"] = on8(lambda v: lax.all_to_all(v, "all", 0, 1, tiled=True))(T.X8.reshape(8, 16, 3))
out["gather"] = on8(lambda v: lax.all_gather(v, "all", tiled=False))(T.X8)
out["gather_tiled"] = on8(lambda v: lax.all_gather(v, "all", tiled=True))(T.X8)
out["psum8"] = on8(lambda v: lax.psum(v, "all"))(T.X8)
out["psum_data"] = on24(lambda v: lax.psum(v, "data"))(T.X24)
out["psum_pod"] = on24(lambda v: lax.psum(v, "pod"))(T.X24)
out["psum_both"] = on24(lambda v: lax.psum(v, ("pod", "data")))(T.X24)
out["gather_pod"] = on24(lambda v: lax.all_gather(v, "pod"))(T.X24)
out["ppermute_data"] = on24(lambda v: lax.ppermute(v, "data", [(i, (i + 1) % 4) for i in range(4)]))(T.X24)
out["index_pod"] = on24(lambda v: lax.axis_index("pod") + 0 * v[0, 0].astype("int32"))(T.X24)
out["index_data"] = on24(lambda v: lax.axis_index("data") + 0 * v[0, 0].astype("int32"))(T.X24)
out["dyn_index"] = on8(lambda v: lax.dynamic_index_in_dim(v, (lax.axis_index("all") * 3) % 8, keepdims=False))(T.X8)
out["dyn_slice"] = on8(lambda v: lax.dynamic_slice_in_dim(v, lax.axis_index("all") - 2, 3))(T.X8)
out["dyn_update"] = on8(lambda v: lax.dynamic_update_index_in_dim(v, v[0] * 0 - 1, (lax.axis_index("all") * 5) % 8, 0))(T.X8)
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("OK")
"""


@pytest.fixture(scope="module")
def lax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_mesh") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        return dict(f)


def _mesh8():
    return Mesh(("all",), (8,), device="cpu")


def _mesh24():
    return Mesh(("pod", "data"), (2, 4), device="cpu")


def _port(name):
    m8, m24 = _mesh8(), _mesh24()
    x8, x24 = m8.shard(X8), m24.shard(X24)
    ring = [(i, (i + 1) % 8) for i in range(8)]
    cases = {
        "ppermute_ring": lambda: m8.ppermute(x8, "all", ring),
        "ppermute_partial": lambda: m8.ppermute(x8, "all", PARTIAL),
        "a2a": lambda: m8.all_to_all(x8, "all", 0, 0),
        "a2a_split1": lambda: m8.all_to_all(x8.reshape(8, 2, 8, 3), "all", 1, 0),
        "a2a_tiled": lambda: m8.all_to_all(x8.reshape(8, 16, 3), "all", 0, 0, tiled=True),
        "a2a_tiled_c1": lambda: m8.all_to_all(x8.reshape(8, 16, 3), "all", 0, 1, tiled=True),
        "gather": lambda: m8.all_gather(x8, "all"),
        "gather_tiled": lambda: m8.all_gather(x8, "all", tiled=True),
        "psum8": lambda: m8.psum(x8, "all"),
        "psum_data": lambda: m24.psum(x24, "data"),
        "psum_pod": lambda: m24.psum(x24, "pod"),
        "psum_both": lambda: m24.psum(x24, ("pod", "data")),
        "gather_pod": lambda: m24.all_gather(x24, "pod"),
        "ppermute_data": lambda: m24.ppermute(x24, "data", [(i, (i + 1) % 4) for i in range(4)]),
        "index_pod": lambda: m24.axis_index("pod"),
        "index_data": lambda: m24.axis_index("data"),
        "dyn_index": lambda: m8.dynamic_index_in_dim(x8, (m8.axis_index("all") * 3) % 8),
        "dyn_slice": lambda: m8.dynamic_slice_in_dim(x8, m8.axis_index("all") - 2, 3),
        "dyn_update": lambda: m8.dynamic_update_index_in_dim(
            x8.clone(), -torch.ones((8, 6)), (m8.axis_index("all") * 5) % 8),
    }
    return cases[name]()


CASES = ["ppermute_ring", "ppermute_partial", "a2a", "a2a_split1", "a2a_tiled",
         "a2a_tiled_c1", "gather", "gather_tiled", "psum8", "psum_data", "psum_pod",
         "psum_both", "gather_pod", "ppermute_data", "index_pod", "index_data",
         "dyn_index", "dyn_slice", "dyn_update"]


@pytest.mark.parametrize("name", CASES)
def test_mesh_op_matches_lax(lax_out, name):
    got = _port(name).numpy()
    want = lax_out[name]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def test_all_to_all_is_a_transpose_of_sender_and_receiver():
    m = _mesh8()
    x = m.shard(X8)
    recv = m.all_to_all(x, "all")
    for d in range(8):
        for s in range(8):
            np.testing.assert_array_equal(recv[d, s].numpy(), X8[s, d])


def test_psum_with_axis_index_groups():
    # lax.psum's axis_index_groups has no shard_map lowering on this jax; numpy is the oracle
    m = _mesh8()
    got = m.psum(m.shard(X8), "all", axis_index_groups=GROUPS).numpy()
    for g in GROUPS:
        for i in g:
            np.testing.assert_array_equal(got[i], X8[g].sum(0))
    with pytest.raises(ValueError, match="partition"):
        m.psum(m.shard(X8), "all", axis_index_groups=[[0, 1], [2, 3]])


def test_shard_takes_arrays_and_per_device_lists():
    m = _mesh24()
    a = m.shard(X24)
    b = m.shard([X24[i, j] for i in range(2) for j in range(4)])
    assert a.device.type == "cpu" and torch.equal(a, b)
    with pytest.raises(ValueError, match="mesh"):
        m.shard(X8)


def test_mesh_validation():
    with pytest.raises(ValueError):
        Mesh(("a", "b"), (2,), device="cpu")
    with pytest.raises(ValueError):
        Mesh(("a", "a"), (2, 2), device="cpu")
    m = _mesh8()
    with pytest.raises(ValueError, match="unknown mesh axis"):
        m.axis_size("data")
    with pytest.raises(ValueError, match="twice"):
        m.ppermute(m.shard(X8), "all", [(0, 1), (2, 1)])


def test_mesh_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh(("all",), (8,))


def test_port_imports_neither_jax_nor_the_reference():
    """Import every repro_torch module in a fresh interpreter: no jax* and
    no repro.* module may be loaded."""
    import pkgutil

    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.kernels.segment_reduce" in names and len(names) >= 15
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0].startswith('jax')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
    )
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
