"""The port's in-transit scan (``core/ring_scan.py``) and pipeline
(``core/pipeline.py``) against the JAX package's, and the port's import
hygiene.

One subprocess runs the JAX functions under ``shard_map`` on 8 emulated
CPU devices (4 for the cases that name 4) for every case of ``SCANS`` and
``PIPES`` and writes an ``.npz``; the port runs the same numpy inputs on
its world-dim ``Mesh`` on the CPU. Both must agree within 2e-5 (rtol and
atol), the reference tests' tolerance (``tests/test_ring_scan.py:29,60``,
``tests/test_pipeline.py:33``), and with a sequential float64 recurrence
or stage chain; ``pipeline_stats`` must be equal.
"""
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pipeline import pipeline_apply, pipeline_stats  # noqa: E402
from repro_torch.core.ring_scan import (  # noqa: E402
    inclusive_linear_scan,
    ring_exclusive_scan,
    sequence_parallel_linear_scan,
)
from repro_torch.mesh import Mesh  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = 2e-5  # rtol = atol, as the reference tests hold it

# name: (devices, sequence length, per-position shape, seed, decay kind)
SCANS = {
    "scan_64x5": (8, 64, (5,), 0, "uniform"),  # tests/test_ring_scan.py:12
    "rglru_32x8": (4, 32, (8,), 1, "rglru"),  # tests/test_ring_scan.py:39
    "batched_256x3x7": (8, 256, (3, 7), 2, "uniform"),
    "one_per_device": (8, 8, (4,), 3, "uniform"),
}
# name: (stages, microbatches, microbatch shape, seed)
PIPES = {
    "pipe_4x6": (4, 6, (2, 16), 0),  # tests/test_pipeline.py:14
    "pipe_8x3": (8, 3, (4, 8), 1),  # fewer microbatches than stages
    "pipe_2x5": (2, 5, (3, 2, 6), 2),
}


def scan_inputs(name):
    p, s, shape, seed, kind = SCANS[name]
    rs = np.random.RandomState(seed)
    if kind == "rglru":
        a = np.exp(-0.1 - rs.rand(s, *shape).astype(np.float32))
        b = np.sqrt(np.clip(1 - a * a, 1e-12, None)) * rs.randn(s, *shape).astype(np.float32)
    else:
        a = (0.5 + 0.5 * rs.rand(s, *shape)).astype(np.float32)  # decay in (0.5, 1)
        b = rs.randn(s, *shape).astype(np.float32)
    return a.astype(np.float32), b.astype(np.float32)


def pipe_inputs(name):
    p, n, shape, seed = PIPES[name]
    rs = np.random.RandomState(seed)
    d = shape[-1]
    ws = (rs.randn(p, d, d) * 0.3).astype(np.float32)
    x = rs.randn(n, *shape).astype(np.float32)
    return ws, x


def stage(w, h):
    """One pipeline stage on every device: tanh(h @ w), each device's
    (d, d) weights broadcast over its microbatch's leading dims."""
    lead = w.shape[:-2]
    w = w.reshape(lead + (1,) * (h.ndim - len(lead) - 2) + w.shape[-2:])
    return torch.tanh(h @ w)


def sequential_scan(a, b):
    h = np.zeros(a.shape[1:], np.float64)
    out = np.empty(a.shape, np.float64)
    for t in range(a.shape[0]):
        h = a[t].astype(np.float64) * h + b[t]
        out[t] = h
    return out


JAX_SIDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {tests!r})
import test_torch_ring_scan as T
from repro.core.pipeline import pipeline_apply, pipeline_stats
from repro.core.ring_scan import sequence_parallel_linear_scan

out = {{}}
for name, (p, *_ ) in T.SCANS.items():
    mesh = jax.make_mesh((p,), ("seq",), devices=jax.devices()[:p],
                         axis_types=(jax.sharding.AxisType.Auto,))
    a, b = T.scan_inputs(name)
    f = jax.shard_map(lambda a_, b_: sequence_parallel_linear_scan(a_, b_, "seq"), mesh=mesh,
                      in_specs=(P("seq"), P("seq")), out_specs=P("seq"))
    out[name] = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
for name, (p, n, shape, seed) in T.PIPES.items():
    mesh = jax.make_mesh((p,), ("pipe",), devices=jax.devices()[:p],
                         axis_types=(jax.sharding.AxisType.Auto,))
    ws, x = T.pipe_inputs(name)
    run = jax.shard_map(lambda w, m: pipeline_apply(lambda w_, h: jnp.tanh(h @ w_), w[0], m, "pipe"),
                        mesh=mesh, in_specs=(P("pipe"), P()), out_specs=P())
    out[name] = np.asarray(run(jnp.asarray(ws), jnp.asarray(x)))
np.savez({path!r}, **out)
st = [pipeline_stats(p, n) for p, n in ((4, 12), (4, 48), (8, 32), (1, 1))]
print(json.dumps([[s.ticks, s.bubble_fraction, s.efficiency] for s in st]))
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ring_scan") / "out.npz"
    stdout = multidevice(JAX_SIDE.format(tests=str(REPO / "tests"), path=str(path)))
    stats = json.loads(stdout.strip().splitlines()[-1])
    return dict(np.load(path)), stats


@pytest.mark.parametrize("name", sorted(SCANS))
def test_sequence_parallel_scan_matches_jax(jax_out, name):
    p = SCANS[name][0]
    a, b = scan_inputs(name)
    mesh = Mesh(("seq",), (p,), device="cpu")
    chunk = lambda x: mesh.shard(x.reshape((p, -1) + x.shape[1:]))  # noqa: E731
    got = sequence_parallel_linear_scan(chunk(a), chunk(b), mesh, "seq")
    got = got.reshape(a.shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jax_out[0][name], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, sequential_scan(a, b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(SCANS))
def test_ring_exclusive_scan_folds_every_earlier_device(name):
    """The device-prefix fold alone: device r gets the fold of devices
    0..r−1's (A, S) summaries, identity (1, 0) on device 0."""
    p = SCANS[name][0]
    a, b = scan_inputs(name)
    mesh = Mesh(("seq",), (p,), device="cpu")
    fa, fs = ring_exclusive_scan(mesh.shard(a[:p]), mesh.shard(b[:p]), mesh, "seq")
    want_a = np.concatenate([np.ones_like(a[:1]), np.cumprod(a[:p - 1], axis=0)])
    want_s = np.concatenate([np.zeros_like(b[:1]), sequential_scan(a[:p - 1], b[:p - 1])])
    np.testing.assert_allclose(fa.numpy(), want_a, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(fs.numpy(), want_s, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(fa[0].numpy(), np.ones_like(a[0]))
    np.testing.assert_array_equal(fs[0].numpy(), np.zeros_like(b[0]))


def test_ring_exclusive_scan_refuses_a_ring_that_is_not_a_power_of_two():
    mesh = Mesh(("seq",), (6,), device="cpu")
    x = torch.ones((6, 3))
    with pytest.raises(ValueError, match="power-of-two"):
        ring_exclusive_scan(x, x, mesh, "seq")


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_inclusive_linear_scan_matches_the_sequential_recurrence(n):
    rs = np.random.RandomState(n)
    a = (0.5 + 0.5 * rs.rand(3, n, 4)).astype(np.float32)
    b = rs.randn(3, n, 4).astype(np.float32)
    ha, hb = inclusive_linear_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    want = np.stack([sequential_scan(a[i], b[i]) for i in range(3)])
    np.testing.assert_allclose(hb.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ha.numpy(), np.cumprod(a, axis=1), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_apply_matches_jax(jax_out, name):
    p, n, shape, _ = PIPES[name]
    ws, x = pipe_inputs(name)
    mesh = Mesh(("pipe",), (p,), device="cpu")
    got = pipeline_apply(stage, mesh.shard(ws), torch.from_numpy(x), mesh, "pipe")
    assert tuple(got.shape) == (p, n) + shape
    want = x.astype(np.float64)
    for s in range(p):
        want = np.tanh(want @ ws[s])
    for r in range(p):  # every device holds the last stage's outputs
        np.testing.assert_allclose(got[r].numpy(), jax_out[0][name], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[r].numpy(), want, rtol=TOL, atol=TOL)


def test_pipeline_on_a_two_axis_mesh_runs_each_row_on_its_own():
    """On a ("data", "pipe") mesh each data row pipelines its own stage
    weights; its outputs are its own stage chain's."""
    ws, x = pipe_inputs("pipe_4x6")
    w2 = np.stack([ws, ws[::-1].copy()])
    mesh = Mesh(("data", "pipe"), (2, 4), device="cpu")
    got = pipeline_apply(stage, mesh.shard(w2), torch.from_numpy(x), mesh, "pipe")
    for row in range(2):
        want = x.astype(np.float64)
        for s in range(4):
            want = np.tanh(want @ w2[row, s])
        for r in range(4):
            np.testing.assert_allclose(got[row, r].numpy(), want, rtol=TOL, atol=TOL)


def test_pipeline_stats_match_jax(jax_out):
    got = [[s.ticks, s.bubble_fraction, s.efficiency]
           for s in (pipeline_stats(p, n) for p, n in ((4, 12), (4, 48), (8, 32), (1, 1)))]
    assert got == jax_out[1]
    assert got[0] == [15, 3 / 15, 12 / 15]


# -------------------------------------------------------- import hygiene --
_JAX_OR_REFERENCE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", *sorted((REPO / "examples").glob("torch_*.py"))]
    return files


def test_port_sources_import_neither_jax_nor_the_reference():
    """By text: no ``import jax``/``from jax`` and no ``repro`` import (the
    reference package) in the port, ``chip_smoke.py`` or the ``torch_``
    examples."""
    files = _port_files()
    assert len(files) > 60 and any(f.name == "torch_scheduler_demo.py" for f in files)
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
           for f in files for m in _JAX_OR_REFERENCE.finditer(f.read_text())]
    assert bad == []


def test_port_imports_with_jax_and_the_reference_blocked():
    """In a fresh interpreter where importing ``jax`` or ``repro`` raises,
    every module of the port, ``chip_smoke.py`` and the ``torch_``
    examples import, and the verify CLI lints an example."""
    import pkgutil

    import repro_torch

    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert {"repro_torch.autotune", "repro_torch.p4mr.scheduler", "repro_torch.core.ring_scan",
            "repro_torch.verify.__main__", "repro_torch.telemetry.report"} <= set(names)
    scripts = [str(f) for f in _port_files() if f.parent.name == "examples" or f.name == "chip_smoke.py"]
    code = (
        "import importlib, importlib.abc, importlib.util, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        f"for i, f in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from repro_torch.verify.__main__ import main\n"
        f"rc = main([{str(REPO / 'examples' / 'paper_fig2.p4mr')!r}])\n"
        "print('RC', rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RC 0" in proc.stdout, proc.stdout


def test_examples_take_device_cpu():
    """Each ``torch_`` example names ``--device`` with the card as its
    default (it runs on the host only when asked)."""
    for f in sorted((REPO / "examples").glob("torch_*.py")):
        spec = importlib.util.spec_from_file_location(f.stem, f)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        args = mod.parse_args(["--device", "cpu"])
        assert args.device == "cpu" and mod.parse_args([]).device is None, f.name
