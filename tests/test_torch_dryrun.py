"""The port's shape table, roofline and dry run vs the JAX package's, on the
CPU.

The reference's ``launch/shapes.py`` tables and ``analysis/roofline.py``
functions are imported here (they need no devices). Held equal: the shape
table, the microbatch counts and which cells run (all 40 cells); the
prefill and decode input specs, the reference's on a (W, 1) mesh with its
model dim of 1 dropped; and bitwise, for every config, the linear solves
(on seeded cost vectors), the analytic attention areas, the FLOP
adjustment at tp 1 on a data world of 16, the model FLOPs and the active
parameter counts. The dry run itself (on the ``meta`` device): the probes'
solve against a direct count at three superblocks (exact: every op is
counted once, so the costs are linear in depth), and ``lower_cell`` on a
dense, an MoE and an enc-dec cell (cut to two layers) and a skip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.launch.mesh import (data_extent, make_mesh, make_production_mesh,  # noqa: E402
                                     mesh_axis_sizes)
from repro_torch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

META = torch.device("meta")
# keys of the reference's dry-run record that mean the same thing here
SAME_KEYS = {"arch", "shape", "mesh", "scenario", "impl", "tp", "rep", "microbatches",
             "probe_s", "attn_flops_adjustment", "devices", "flops_per_dev",
             "hbm_bytes_per_dev", "collectives", "wire_bytes_per_dev", "t_compute_s",
             "t_memory_s", "t_collective_s", "bottleneck", "model_flops_per_dev",
             "useful_flops_ratio", "roofline_fraction"}


def _ref_env(world: int, pod: int = 1):
    from repro.models.parallel import ShardEnv

    return ShardEnv(model_size=1, data_size=world, pod_size=pod, tp=1,
                    pod_axis="pod" if pod > 1 else None)


def _world(world: int, pod: int = 1) -> Mesh:
    if pod > 1:
        return Mesh(("pod", "data"), (pod, world), device="cpu")
    return Mesh(("data",), (world,), device="cpu")


def test_shape_table_and_applicability_match_the_reference():
    from repro.configs import get_config as ref_config
    from repro.launch import shapes as ref

    assert shapes.SHAPES.keys() == ref.SHAPES.keys()
    for name, s in ref.SHAPES.items():
        assert dataclasses.astuple(shapes.SHAPES[name]) == dataclasses.astuple(s)
    assert shapes.TRAIN_MICROBATCHES == ref.TRAIN_MICROBATCHES
    cells = 0
    for arch in ARCHS:
        for name in ref.SHAPES:
            assert shapes.shape_applicable(get_config(arch), name) == \
                ref.shape_applicable(ref_config(arch), name), (arch, name)
            cells += 1
    assert cells == 40


@pytest.mark.parametrize("world,pod", [(16, 1), (4, 1), (16, 2)])
def test_input_specs_match_the_reference(world, pod):
    """The reference's device-major specs on a (pod,) data × model-1 mesh
    without the model dim: the port's world-major ones, for every config,
    prefill at 64 positions and decode, global batches 32 and 1."""
    from repro.configs import get_config as ref_config
    from repro.launch import shapes as ref

    env, mesh = _ref_env(world, pod), _world(world, pod)
    nm = mesh.ndim

    def drop_model(sds):
        return sds.shape[:nm] + sds.shape[nm + 1:], str(sds.dtype)

    for arch in ARCHS:
        for gb in (32, 1):
            want, _ = ref.prefill_input_specs(ref_config(arch), env, 64, gb)
            got = shapes.prefill_input_specs(get_config(arch), mesh, 64, gb)
            assert {k: drop_model(v) for k, v in want.items()} == \
                {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in got.items()}, arch
            want, _ = ref.decode_input_specs(ref_config(arch), env, gb)
            got = shapes.decode_input_specs(get_config(arch), mesh, gb)
            assert drop_model(want["tokens"]) == (got["tokens"][0], "int32")
            assert want["cache_len"].shape == got["cache_len"][0] == ()


def test_linear_solves_match_the_reference_bitwise():
    from repro.analysis import roofline as ref

    rs = np.random.RandomState(0)
    for _ in range(20):
        c = [rs.rand(rl.NCOST) * 10.0 ** rs.randint(0, 15) for _ in range(5)]
        n, mb, le = int(rs.randint(1, 100)), int(rs.randint(1, 17)), int(rs.randint(0, 25))
        for args, kw in (((c[0], c[1], c[2], n, mb), dict(c_enc2=c[3], enc_units=le, c22=c[4])),
                         ((c[0], c[1], None, n, 1), {}), ((c[0], c[1], c[2], n, mb), {})):
            got = rl.solve_train(*args, **kw)
            want = ref.solve_train(*args, **kw)
            assert np.array_equal(got, want)
        assert np.array_equal(rl.solve_inference(c[0], c[1], n, c_enc2=c[3], enc_units=le),
                              ref.solve_inference(c[0], c[1], n, c_enc2=c[3], enc_units=le))
    assert rl.NCOST == ref.NCOST


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_functions_match_the_reference_bitwise(arch):
    """Attention areas (masked, triangle, direct; causal or not), the FLOP
    adjustment at tp 1 on a data world of 16 (train and not), the model
    FLOPs and the active parameters, on every shape."""
    from repro.analysis import roofline as ref
    from repro.configs import get_config as ref_config

    cfg, rcfg = get_config(arch), ref_config(arch)
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.param_count() == rcfg.param_count()
    assert rl.attn_layers_per_unit_and_tail(cfg) == ref.attn_layers_per_unit_and_tail(rcfg)
    for seq in (256, 1024, 4096, 16384, 32768):
        for impl in ("masked", "triangle", "direct"):
            for causal in (True, False):
                assert rl.analytic_attn_area(cfg, seq, impl, causal=causal) == \
                    ref.analytic_attn_area(rcfg, seq, impl, causal=causal)
    for shape in shapes.SHAPES.values():
        for impl in ("masked", "triangle"):
            for train in (True, False):
                assert rl.attn_flops_adjustment(cfg, shape, 16, impl, train=train) == \
                    ref.attn_flops_adjustment(rcfg, shape, _ref_env(16), impl, train=train)
        for n_dev in (1, 16, 256):
            assert rl.model_flops(cfg, shape, n_dev) == ref.model_flops(rcfg, shape, n_dev)


def test_wire_and_terms_use_the_h100_and_the_reference_s_ring_factors():
    from repro.analysis import roofline as ref

    v = np.array([3e15, 2e12, 1e9, 2e9, 3e9, 4e9, 5e9])
    got = rl.wire_and_terms(rl.ExactCosts.from_vector(v), world_hint=16)
    want = ref.wire_and_terms(ref.ExactCosts.from_vector(v), world_hint=16)
    assert got["wire_bytes_per_dev"] == want["wire_bytes_per_dev"]
    assert got["t_compute_s"] == 3e15 / 989e12 and got["t_memory_s"] == 2e12 / 3.35e12
    assert got["t_collective_s"] == want["wire_bytes_per_dev"] / 450e9
    assert rl.ExactCosts.from_vector(v).coll == ref.ExactCosts.from_vector(v).coll


def test_cost_vector_counts_flops_bytes_and_collectives():
    """A matmul's 2mnk FLOPs and its operands' and result's bytes (a view
    is free); a mesh collective's output bytes, every rank's."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    c = rl.cost_vector(lambda: (a @ b).t())
    assert c[0] == 2 * 8 * 16 * 4 and c[1] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    mesh = Mesh(("data",), (4,), device="cpu")
    x = torch.ones(4, 10)
    c = rl.cost_vector(lambda: (mesh.psum(x, "data"), mesh.ppermute(x, "data", [(0, 1)])))
    assert c[2:].tolist() == [0, 4 * 10 * 4, 0, 0, 4 * 10 * 4]


def test_production_mesh_and_mesh_helpers():
    """The reference's production meshes, model axis included; training's
    data world is the mesh's data extent, whatever its model axis."""
    m = make_production_mesh(device=META)
    assert m.axis_names == ("data", "model") and m.shape == (16, 16)
    m2 = make_production_mesh(multi_pod=True, device=META)
    assert m2.axis_names == ("pod", "data", "model") and m2.shape == (2, 16, 16)
    assert mesh_axis_sizes(m2) == {"pod": 2, "data": 16, "model": 16}
    w = data_extent(make_mesh((4, 1), ("data", "model"), device="cpu"))
    assert (w.axis_names, w.shape) == (("data",), (4,))
    w16 = data_extent(m)
    assert (w16.axis_names, w16.shape) == (("data",), (16,))
    with pytest.raises(ValueError, match="axes"):
        make_mesh((4, 1), ("x", "model"), device="cpu")


@pytest.mark.parametrize("arch,kind", [("qwen1.5-0.5b", "train"), ("granite-moe-1b-a400m", "train"),
                                       ("recurrentgemma-2b", "train"),
                                       ("seamless-m4t-large-v2", "prefill"),
                                       ("recurrentgemma-2b", "decode")])
def test_probe_solve_predicts_a_direct_count_exactly(arch, kind):
    """At a smoke config with three superblocks (recurrentgemma's tail and
    seamless's encoder included), two microbatches for train: the probes'
    solve equals the step counted at that depth (FLOPs, bytes and
    collectives) to float64 rounding."""
    cfg = dataclasses.replace(get_smoke_config(arch), name=get_config(arch).name)
    unit = len(cfg.pattern or (1,))
    cfg = dataclasses.replace(cfg, n_layers=3 * unit + len(cfg.pattern_tail))
    shape = shapes.ShapeSpec("probe", 64, 8, kind)
    mesh = make_mesh((2, 1), device=META)
    total, _ = dryrun.probe_costs(cfg, shape, mesh, scenario="s2_in_net", impl="direct", mb=2)
    direct = dryrun.Cell(cfg, shape, mesh, scenario="s2_in_net", impl="direct",
                         microbatches=2).cost()
    assert direct[0] > 0
    np.testing.assert_allclose(total, direct, rtol=1e-12, atol=0)


def test_lower_cell_records(tmp_path):
    """A dense train cell, an MoE prefill (balanced routing, named), an
    enc-dec decode (each cut to two layers) and a skip: the reference's
    record keys, one card, the peak the held state plus the step's. The
    cells run on the production mesh at the reference's tp
    (``resolve_tp(16)``) and rep, the train cell's one rank scaled by the
    data-parallel world; ``serve_opt`` is the compute-at-data decode."""
    from repro.launch.shapes import shape_applicable as ref_applicable
    from repro.configs import get_config as ref_config

    cut = {"n_layers": 2}
    dense = dryrun.lower_cell("qwen1.5-0.5b", "train_4k", cfg_overrides=cut)
    moe_rec = dryrun.lower_cell("granite-moe-1b-a400m", "prefill_32k", cfg_overrides=cut)
    encdec = dryrun.lower_cell("seamless-m4t-large-v2", "decode_32k",
                               cfg_overrides={"n_layers": 2, "enc_layers": 2})
    for rec in (dense, moe_rec, encdec):
        assert SAME_KEYS <= set(rec), SAME_KEYS - set(rec)
        assert rec["devices"] == 1 and "not comparable" in rec["note"]
        assert rec["peak_bytes"] == rec["held_bytes"] + rec["transient_bytes"]
        assert rec["fits_80g"] == (rec["peak_bytes"] < 80e9)
        assert rec["flops_per_dev"] >= rec["model_flops_per_dev"] * 0.5 > 0
    assert dense["world"] == 16 and dense["microbatches"] == 1
    assert (dense["tp"], dense["rep"], dense["mesh"]) == (ref_config("qwen1.5-0.5b").resolve_tp(16),
                                                          1, "16x16")
    assert "model_axis" not in dense and "rows" not in dense and dense["rep_split"] is False
    for rec, arch in ((moe_rec, "granite-moe-1b-a400m"), (encdec, "seamless-m4t-large-v2"),
                      (dryrun.lower_cell("qwen2-vl-7b", "decode_32k", cfg_overrides=cut,
                                         probes=False), "qwen2-vl-7b")):
        tp = ref_config(arch).resolve_tp(16)
        assert (rec["tp"], rec["rep"], rec["mesh"]) == (tp, 16 // tp, "16x16"), arch
        assert "model_axis" not in rec and rec["rows"] == shapes.SHAPES[rec["shape"]].global_batch
    assert moe_rec["tp"] == 16 and moe_rec["collectives"]["all-to-all"] > 0  # the a2a dispatch
    assert moe_rec["collectives"]["all-reduce"] > 0  # the row-parallel products' psum_tp
    opt = dryrun.lower_cell("qwen1.5-0.5b", "decode_32k", impl="serve_opt", cfg_overrides=cut)
    plain = dryrun.lower_cell("qwen1.5-0.5b", "decode_32k", cfg_overrides=cut)
    assert opt["impl"] == "serve_opt" and opt["tp"] == plain["tp"] == 16
    assert opt["hbm_bytes_per_dev"] > plain["hbm_bytes_per_dev"]  # the MLP's d-slice partials
    assert dense["collectives"]["reduce-scatter"] > 0  # native: each FSDP leaf's psum_scatter
    assert moe_rec["moe_routing"] == moe.BALANCED and "moe_routing" not in dense
    # a decode cell holds its cache: 2 layers of self and cross k/v, bf16
    cfg = get_config("seamless-m4t-large-v2")
    kv = 2 * 2 * 2 * 128 * 16384 * cfg.n_kv_heads * cfg.hd * 2
    assert encdec["held_bytes"] > kv
    skip = dryrun.lower_cell("qwen1.5-0.5b", "long_500k")
    assert skip == {"arch": "qwen1.5-0.5b", "shape": "long_500k",
                    "skipped": ref_applicable(ref_config("qwen1.5-0.5b"), "long_500k")[1]}
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--jobs", "1",
                        "--out", str(out)]) == 0
    assert out.exists()


def test_meta_moe_counts_balanced_routing():
    experts = torch.empty((10, 3), dtype=torch.int64, device=META)
    assert moe.group_sizes(experts, 4) == [8, 8, 7, 7]
    assert moe.expert_counts(experts, 4).shape == (4,)
    real = torch.tensor([[0, 1], [1, 3], [1, 0]])
    assert moe.group_sizes(real, 4) == [2, 3, 0, 1]
