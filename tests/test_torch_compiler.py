"""The port's compiler, verifier, tracer and torch backend against the JAX
package, on the same inputs.

The compile side of both packages runs in this process (it needs no
devices): pass records, placements, routes, verifier diagnostics and
trace spans are compared directly. One subprocess runs the JAX package's
``plan.run(backend="jax")`` on 8 fake CPU devices, and its
``backend="reference"``, for every case of ``RUN_CASES``, and writes an
``.npz``; the port's ``plan.run(backend="torch", device="cpu")`` must equal
the JAX backend bitwise (S3's bf16 adds included), and its ``"reference"``
must equal the JAX reference in values and dtype.

The JAX package is imported on first use (``NS["jax"]``), so the
``cuda``-marked test runs on a machine that has the card and no JAX.
"""
import dataclasses
import importlib
import json
import os
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import compiler as t_compiler  # noqa: E402
from repro_torch.core import dag as t_dag, topology as t_topology  # noqa: E402
from repro_torch.core import wordcount as t_wordcount  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

# the optimizing pipeline without lower-shuffle and reroute-feedback: the
# cases below that predate those passes keep it, so their plans stay as
# they were
P = ("parse", "validate", "dead-node-elim", "rebalance-reduce-tree",
     "insert-combiners", "place", "route", "emit", "verify")
UNOPT = ("parse", "validate", "place", "route", "emit", "verify")

_MODULES = {"compiler": "compiler", "verify": "verify", "dag": "core.dag", "dsl": "core.dsl",
            "prim": "core.primitives", "routing": "core.routing",
            "scenarios": "core.scenarios", "topology": "core.topology",
            "wordcount": "core.wordcount", "trace": "telemetry.trace"}


class _Packages(dict):
    """"jax" → the JAX package's modules, "torch" → the port's, each
    namespace imported when first asked for."""

    def __missing__(self, name):
        root = {"jax": "repro", "torch": "repro_torch"}[name]
        ns = self[name] = types.SimpleNamespace(**{
            k: importlib.import_module(f"{root}.{m}") for k, m in _MODULES.items()})
        return ns


NS = _Packages()


def both(fn):
    """``fn`` run on the JAX package and on the port: (want, got)."""
    return fn(NS["jax"]), fn(NS["torch"])


# ----------------------------------------------------------------- cases --
BUCKET_CONCAT_SRC = (
    'A := store<uint_64>("d1:a", 8);\n'
    'B := store<uint_64>("d5:b", 8);\n'
    "A0 := BUCKET(A, 0, 2, 0, 4);\n"
    "A1 := BUCKET(A, 1, 2, 4, 4);\n"
    "B0 := BUCKET(B, 0, 2, 0, 4);\n"
    "B1 := BUCKET(B, 1, 2, 4, 4);\n"
    "R0 := SUM<4>(A0, B0);\n"
    "R1 := MAX<4>(A1, B1);\n"
    "R := CONCAT(R1, R0);\n"
    'OUT := COLLECT(R, "d3");\n'
)


def _kind_program(ns, kind, world=8, width=16):
    p = ns.dag.Program()
    for i in range(world):
        p.store(f"s{i}", host=f"d{i}", items=width)
    p.map("m3", "s3", fn_name="negate")
    p.map("m5", "s5", fn_name="square")
    srcs = [f"s{i}" for i in range(world) if i not in (3, 5)] + ["m3", "m5"]
    p.reduce("R", *srcs, kind=getattr(ns.prim.ReduceKind, kind), state_width=width)
    p.collect("OUT", "R", sink_host="d6")
    return p


def _bf16_fanin(ns, world=8, width=48):
    """Every worker's gradient to bf16 on the wire, one 8-way SUM of them."""
    p = ns.dag.Program()
    for i in range(world):
        p.store(f"g{i}", host=f"d{i}", items=width)
        p.map(f"w{i}", f"g{i}", fn_name="to_bf16")
    p.sum("R", *[f"w{i}" for i in range(world)], state_width=width)
    p.map("U", "R", fn_name="from_bf16")
    p.collect("OUT", "U", sink_host="d0")
    return p


def _paper_collect(ns):
    return ns.dsl.ast_to_program(ns.dsl.parse_ast(ns.dsl.PAPER_SOURCE + 'OUT := COLLECT(E, "h6");\n'))


RING8 = lambda ns: ns.topology.TorusTopology(dims=(8,))  # noqa: E731

# name: (program, topology, passes, pins, item dtype)
RUN_CASES = {
    "wordcount_tree": (lambda ns: ns.wordcount.wordcount_program(8, 40), RING8, P, None, None),
    "wordcount_keyby": (lambda ns: ns.wordcount.wordcount_shuffle_program(8, 40, num_buckets=8),
                        RING8, UNOPT, None, None),
    "paper_indexed": (_paper_collect, lambda ns: ns.topology.paper_topology().as_indexed(8),
                      UNOPT, None, None),
    "paper_indexed_opt": (lambda ns: ns.dag.paper_example(),
                          lambda ns: ns.topology.paper_topology().as_indexed(), P, None, None),
    "s1": (lambda ns: ns.scenarios.scenario_program(8, "s1_host", state_width=48), RING8,
           UNOPT, lambda topo: {"R": topo.attach_switch("d0")}, None),
    "s2": (lambda ns: ns.scenarios.scenario_program(8, "s2_in_net", state_width=48),
           RING8, P, None, None),
    "s3": (lambda ns: ns.scenarios.scenario_program(8, "s3_in_net_map", state_width=48),
           RING8, P, None, None),
    "s3_chain": (lambda ns: ns.scenarios.scenario_program(8, "s3_in_net_map", state_width=48),
                 RING8, UNOPT, None, None),
    "bf16_fanin8": (_bf16_fanin, RING8, UNOPT, None, None),
    "s2_bf16_items": (lambda ns: ns.scenarios.scenario_program(8, "s2_in_net", state_width=48),
                      RING8, P, None, "bfloat16"),
    "max": (lambda ns: _kind_program(ns, "MAX"), RING8, P, None, None),
    "min": (lambda ns: _kind_program(ns, "MIN"), RING8, UNOPT, None, None),
    "bucket_concat": (lambda ns: ns.dsl.ast_to_program(ns.dsl.parse_ast(BUCKET_CONCAT_SRC)),
                      RING8, UNOPT, None, None),
}


def compile_case(ns, name):
    prog, topo_fn, passes, pins_fn, _ = RUN_CASES[name]
    topo = topo_fn(ns)
    return ns.compiler.compile(prog(ns), topo, passes=passes,
                               pins=pins_fn(topo) if pins_fn else None)


def item_dtype(ns_name, name):
    dt = RUN_CASES[name][4]
    if dt is None:
        return None
    if ns_name == "jax":
        import jax.numpy as jnp
        return getattr(jnp, dt)
    return getattr(torch, dt)


def case_inputs(name):
    """Each Store's array, from a seed: word-count histograms as integer
    counts, everything else as normals (S3's bf16 wire rounds them)."""
    prog = RUN_CASES[name][0](NS["torch"])
    rs = np.random.RandomState(sorted(RUN_CASES).index(name))
    out = {}
    for label in prog.sources():
        n = prog.nodes[label].items or 1
        if name.startswith("wordcount"):
            out[label] = rs.poisson(3.0, size=n).astype(np.float64)
        else:
            out[label] = rs.randn(n) / 3.0
    return out


JAX_SCRIPT = r"""
import json, sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_compiler as T
out, dtypes = {{}}, {{}}
for name in T.RUN_CASES:
    plan = T.compile_case(T.NS["jax"], name)
    inputs = T.case_inputs(name)
    for k, v in plan.run(inputs, backend="jax", item_dtype=T.item_dtype("jax", name)).items():
        out[f"{{name}}/jax/{{k}}"] = np.asarray(v)
    for k, v in plan.run(inputs, backend="reference").items():
        v = np.asarray(v)
        dtypes[f"{{name}}/ref/{{k}}"] = v.dtype.name
        out[f"{{name}}/ref/{{k}}"] = v.astype(np.float64)
out["dtypes"] = np.array(json.dumps(dtypes))
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_out(multidevice, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_compiler") / "out.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    assert "OK" in multidevice(JAX_SCRIPT.format(tests=tests, path=path))
    with np.load(path) as f:
        out = dict(f)
    out["dtypes"] = json.loads(str(out["dtypes"]))
    return out


# ---------------------------------------------------- the torch backend --
@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_torch_backend_matches_jax_backend_bitwise(jax_out, name):
    plan = compile_case(NS["torch"], name)
    got = plan.run(case_inputs(name), backend="torch", device="cpu",
                   item_dtype=item_dtype("torch", name))
    assert sorted(got) == sorted(plan.sinks)
    for sink, v in got.items():
        want = jax_out[f"{name}/jax/{sink}"]
        assert v.dtype == want.dtype == np.float64
        assert v.shape == want.shape
        np.testing.assert_array_equal(v, want)
        # bitwise, not only equal: the same bits, signs of zeros included
        np.testing.assert_array_equal(v.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_reference_backend_matches_jax_reference(jax_out, name):
    plan = compile_case(NS["torch"], name)
    got = plan.run(case_inputs(name), backend="reference")
    for sink, v in got.items():
        key = f"{name}/ref/{sink}"
        assert v.dtype.name == jax_out["dtypes"][key]
        np.testing.assert_array_equal(v.astype(np.float64), jax_out[key])


def test_bf16_reduce_adds_one_source_at_a_time():
    """An 8-way bf16 SUM rounds every partial sum to bf16, in srcs order;
    one fp32 sum rounded once (what ``torch.sum`` over bf16 does) differs."""
    name = "bf16_fanin8"
    plan = compile_case(NS["torch"], name)
    inputs = case_inputs(name)
    got = plan.run(inputs, backend="torch", device="cpu")["OUT"]
    rows = [torch.from_numpy(inputs[f"g{i}"]).float().to(torch.bfloat16) for i in range(8)]
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    np.testing.assert_array_equal(got, acc.double().numpy())
    once = torch.stack(rows).sum(0).double().numpy()
    assert not np.array_equal(got, once)


def test_step_on_a_multi_axis_mesh_reads_the_named_axis():
    """``emit_step`` over a mesh whose world axis is not the first dim
    gives each pod the single-axis result."""
    from repro_torch.mesh import Mesh

    name = "s2"
    plan = compile_case(NS["torch"], name)
    inputs = case_inputs(name)
    want = plan.run(inputs, backend="torch", device="cpu")["OUT"]
    mesh = Mesh(("pod", "all"), (2, 8), device="cpu")
    step = plan.torch_step(mesh, axis_name="all")
    big = {k: torch.from_numpy(v).expand((2, 8) + v.shape) for k, v in inputs.items()}
    out = step(big)
    assert out["OUT@all"].shape == (2, 8, 48)
    for pod in range(2):
        np.testing.assert_array_equal(out["OUT@all"][pod, 0].double().numpy(), want)


# ------------------------------------------------------------ the passes --
PASS_CASES = {
    "wordcount_chain": (lambda ns: ns.wordcount.wordcount_program(8, 40), RING8),
    "wordcount_wide": (lambda ns: ns.wordcount.wordcount_program(8, 50_000), RING8),
    "wordcount_keyby": (lambda ns: ns.wordcount.wordcount_shuffle_program(8, 40, num_buckets=8),
                        RING8),
    "s2": (lambda ns: ns.scenarios.scenario_program(8, "s2_in_net", state_width=48), RING8),
    # a 25,557,032-wide state table needs more than the default 1 MiB a
    # switch: 512 MiB holds two of them, as 1 MiB holds two 50,000-word tables
    "s3_wide": (lambda ns: ns.scenarios.scenario_program(8, "s3_in_net_map",
                                                         state_width=25_557_032), RING8,
                dict(switch_memory_bytes=1 << 29)),
    "s1_wide": (lambda ns: ns.scenarios.scenario_program(8, "s1_host",
                                                         state_width=25_557_032), RING8,
                dict(switch_memory_bytes=1 << 29)),
    "s2_torus": (lambda ns: ns.scenarios.scenario_program(16, "s2_in_net", state_width=64),
                 lambda ns: ns.topology.TorusTopology(dims=(4, 4))),
    "paper": (_paper_collect, lambda ns: ns.topology.paper_topology()),
    "paper_fig2": (lambda ns: ns.dsl.ast_to_program(ns.dsl.parse_ast(
        (EXAMPLES / "paper_fig2.p4mr").read_text())), lambda ns: ns.topology.paper_topology()),
    "shared_ingress": (lambda ns: ns.dsl.ast_to_program(ns.dsl.parse_ast(
        'A := store<uint_64>("ip_h1:a", 4);\nB := store<uint_64>("ip_h1:b", 4);\n'
        'C := store<uint_64>("ip_h4:c", 4);\nR := SUM<4>(A, B, C);\n'
        'OUT := COLLECT(R, "h6");\n')), lambda ns: ns.topology.paper_topology()),
}


def _summary_of(plan, ns):
    """What two compiles must share: pass records, program text,
    placement, routes, pins, cost, verifier output, and the
    ``reroute-feedback`` and ``lower-shuffle`` records."""
    return (
        [(r.name, r.summary) for r in plan.pass_records],
        ns.dsl.program_to_source(plan.program),
        dict(plan.placement.assignment),
        [(r.src_label, r.dst_label, list(r.path)) for r in plan.routes.routes],
        dict(plan.pins),
        dataclasses.astuple(plan.cost),
        [d.format() for d in plan.diagnostics or ()],
        plan.feedback,
        repr(plan.shuffle_meta),
    )


def _compiled_summary(ns, name, passes):
    prog, topo_fn, *cost = PASS_CASES[name]
    cm = ns.compiler.CostModel(**cost[0]) if cost else None
    plan = ns.compiler.compile(prog(ns), topo_fn(ns), passes=passes, cost_model=cm)
    return _summary_of(plan, ns) + (plan.describe().split("# passes")[0],)


@pytest.mark.parametrize("passes", [P, UNOPT], ids=["P", "unoptimized"])
@pytest.mark.parametrize("name", sorted(PASS_CASES))
def test_pass_records_placements_and_routes_match_jax(name, passes):
    want, got = both(lambda ns: _compiled_summary(ns, name, passes))
    for w, g in zip(want, got):
        assert g == w


def test_pipeline_constants_match_jax():
    for const in ("DEFAULT_PASSES", "STATIC_ECMP_PASSES", "UNOPTIMIZED_PASSES", "AUTOTUNE_PASSES"):
        assert getattr(NS['torch'].compiler, const) == getattr(NS['jax'].compiler, const)


def test_trace_span_names_match_jax():
    def run(ns):
        tracer = ns.trace.Tracer()
        plan = None
        with ns.trace.activate(tracer):
            plan = ns.compiler.compile(ns.wordcount.wordcount_program(4, 8),
                                       ns.topology.TorusTopology(dims=(4,)), passes=P)
            plan.run({f"s{i}": np.ones(8) for i in range(4)}, backend="reference")
        spans = [s.name for s in tracer.spans]
        chrome = tracer.to_chrome_trace()
        return spans, ns.trace.validate_chrome_trace(chrome), sorted(
            k for s in tracer.spans if s.name.startswith("pass:") for k in s.attrs)

    want, got = both(run)
    assert got == want
    assert "plan.run" in got[0] and "verify.plan" in got[0] and got[1] == []


# -------------------------------------------------------------- verifier --
def _codes(diags):
    return sorted(d.format() for d in diags)


def _paper_plan(ns, **kw):
    return ns.compiler.compile(_paper_collect(ns), ns.topology.paper_topology(), passes=P, **kw)


def _stateful_plan(ns):
    p = ns.dag.Program()
    for i in range(4):
        p.store(f"s{i}", host=f"h{i + 1}", items=16)
    p.sum("R", *[f"s{i}" for i in range(4)], state_width=16)
    p.collect("OUT", "R", sink_host="h6")
    return ns.compiler.compile(p, ns.topology.paper_topology(), passes=UNOPT, pins={"R": "S3"})


def v101(ns):
    a = ns.prim.MapFn(name="A", src="B")
    b = ns.prim.MapFn(name="B", src="A")
    return ns.verify.verify_program(ns.dag.Program(nodes={"A": a, "B": b}))


def v102(ns):
    store = ns.prim.Store(name="A", host="h1", path="p")
    ghost = ns.prim.MapFn(name="M", src="NOPE")
    aliased = ns.dag.Program(nodes={"A": store, "X": ns.prim.MapFn(name="M2", src="A")})
    return (ns.verify.verify_program(ns.dag.Program(nodes={"A": store, "M": ghost}))
            + ns.verify.verify_program(aliased))


def v103(ns):
    p = ns.dag.Program()
    for i in range(6):
        p.store(f"s{i}", host=f"h{i}")
    p.sum("R", *[f"s{i}" for i in range(6)], state_width=4)
    return (ns.verify.verify_program(p, cost_model=ns.compiler.CostModel(max_fanin=2))
            + ns.verify.verify_program(p))


def v106(ns):
    empty = ns.dag.Program(nodes={})
    p = ns.dag.Program(nodes={
        "A": ns.prim.Store(name="A", host="h1", path="p"),
        "R": ns.prim.Reduce(name="R", srcs=(), kind=ns.prim.ReduceKind.SUM),
        "C": ns.prim.Concat(name="C", srcs=()),
    })
    return ns.verify.verify_program(empty) + ns.verify.verify_program(p)


def v110(ns):
    p = ns.dag.Program()
    p.store("A", host="nowhere")
    p.store("B", host="elsewhere")
    p.map("M", "A")
    p.sum("R", "M", "B")
    return ns.verify.verify_program(p, topology=ns.topology.paper_topology())


def _replace(ns, plan, **kw):
    return dataclasses.replace(plan, diagnostics=None, **kw)


def v201(ns):
    plan = _paper_plan(ns)
    assignment = dict(plan.placement.assignment)
    victim = next(iter(assignment))
    assignment[victim] = "S99"
    del assignment[sorted(assignment)[-1]]
    return ns.verify.verify_plan(_replace(
        ns, plan, placement=dataclasses.replace(plan.placement, assignment=assignment)))


def v202(ns):
    plan = _paper_plan(ns, pins={"E": "S2"})
    assignment = dict(plan.placement.assignment)
    assignment["E"] = "S5"
    return ns.verify.verify_plan(_replace(
        ns, plan, placement=dataclasses.replace(plan.placement, assignment=assignment)))


def v203(ns):
    plan = _paper_plan(ns)
    r0 = plan.routes.routes[0]
    looped = _replace(ns, plan, routes=ns.routing.RoutingTable(
        routes=[dataclasses.replace(r0, path=list(r0.path) + [r0.path[0]])] + plan.routes.routes[1:]))
    bad_hop = _replace(ns, plan, routes=ns.routing.RoutingTable(
        routes=[ns.routing.Route(r0.src_label, r0.dst_label, ["S1", "S3"])] + plan.routes.routes[1:]))
    return ns.verify.verify_plan(looped) + ns.verify.verify_plan(bad_hop)


def v204(ns):
    plan = _paper_plan(ns)
    return ns.verify.verify_plan(_replace(
        ns, plan, routes=ns.routing.RoutingTable(routes=plan.routes.routes[1:])))


def v205(ns):
    plan = _stateful_plan(ns)
    used = ns.verify.switch_state_bytes(plan.program, plan.placement.assignment,
                                        plan.cost_model.item_bytes)
    tight = dataclasses.replace(plan.cost_model, switch_memory_bytes=max(used.values()) - 1)
    return ns.verify.verify_plan(_replace(ns, plan, cost_model=tight))


def v301(ns):
    p = ns.dag.Program()
    p.store("a", host="h1")
    p.store("b", host="h2")
    p.store("c", host="h3")
    p.sum("r1", "a", "b", state_width=1)
    p.sum("r2", "r1", "c", state_width=1)
    p.collect("OUT", "r2", sink_host="h6")
    plan = ns.compiler.compile(p, ns.topology.paper_topology(), passes=UNOPT,
                               pins={"r1": "S2", "r2": "S2"})
    return (ns.verify.verify_plan(plan, profile=ns.verify.TargetProfile(
        name="one-stage", pipeline_stages=1))
        + ns.verify.verify_plan(plan, profile=ns.verify.unconstrained()))


def v302(ns):
    plan = _stateful_plan(ns)
    return (ns.verify.verify_plan(plan, profile=ns.verify.TargetProfile(
        name="tiny-stage", stage_memory_bytes=1))
        + ns.verify.verify_plan(plan, profile=ns.verify.TargetProfile(
            name="tiny-total", pipeline_stages=1, stage_memory_bytes=8)))


def v303(ns):
    p = ns.dag.Program()
    for i in range(6):
        p.store(f"s{i}", host=f"h{(i % 6) + 1}")
    p.sum("R", *[f"s{i}" for i in range(6)], state_width=1)
    p.collect("OUT", "R", sink_host="h6")
    plan = ns.compiler.compile(p, ns.topology.paper_topology(), passes=UNOPT)
    return (ns.verify.verify_plan(plan, profile=ns.verify.TargetProfile(
        name="no-recirc", recirculation_budget=2))
        + ns.verify.verify_plan(plan, profile=ns.verify.resolve_profile("tofino_like")))


VERIFY_CASES = {f.__name__.upper(): f for f in (
    v101, v102, v103, v106, v110, v201, v202, v203, v204, v205, v301, v302, v303)}


@pytest.mark.parametrize("code", sorted(VERIFY_CASES))
def test_verifier_diagnostics_match_jax(code):
    want, got = both(lambda ns: _codes(VERIFY_CASES[code](ns)))
    assert got == want
    assert any(line.startswith(code + " ") for line in got)


@pytest.mark.parametrize("case", ["validate_multi_error", "place_over_budget"])
def test_passes_fail_with_the_same_diagnostics(case):
    def run(ns):
        if case == "validate_multi_error":
            p = ns.dag.Program()
            for h in ("nowhere", "elsewhere", "h1"):
                p.store(f"s_{h}", host=h)
            p.sum("R", *[f"s_{h}" for h in ("nowhere", "elsewhere", "h1")])
            args = (p, ns.topology.paper_topology())
            kw = {}
        else:
            args = (ns.scenarios.scenario_program(4, "s2_in_net", state_width=1 << 20),
                    ns.topology.TorusTopology(dims=(4,)))
            kw = {"cost_model": ns.compiler.CostModel(switch_memory_bytes=1 << 10)}
        with pytest.raises(ns.verify.VerificationError) as ei:
            ns.compiler.compile(*args, passes=P, **kw)
        return _codes(ei.value.diagnostics), str(ei.value)

    want, got = both(run)
    assert got == want


# ----------------------------------------------------------- error paths --
def _small_plan():
    return t_compiler.compile(t_wordcount.wordcount_program(4, 8),
                              t_topology.TorusTopology(dims=(4,)), passes=P)


def test_unknown_pass_raises_key_error_as_in_jax():
    for ns in NS.values():
        with pytest.raises(KeyError, match="unknown pass 'no-such-pass'"):
            ns.compiler.compile(ns.dag.paper_example(), ns.topology.paper_topology(),
                                passes=("parse", "no-such-pass"))


@pytest.mark.parametrize("name", ["lower-shuffle", "reroute-feedback", "autotune"])
def test_unported_pass_raises_not_implemented_naming_it(name):
    """Every pass compiles as in the JAX package. The name dates from when
    these passes were unported and raised; it is kept so the test's ID
    stays. Now it checks that a pipeline that adds the pass to ``P``
    (``autotune`` at its end) compiles the reference's plan."""
    assert t_compiler.get_pass(name).pass_name == name
    at = {"lower-shuffle": P.index("rebalance-reduce-tree"), "reroute-feedback": P.index("emit"),
          "autotune": len(P)}[name]
    passes = P[:at] + (name,) + P[at:]

    def run(ns):
        prog = ns.wordcount.wordcount_shuffle_program(8, 40, num_buckets=4,
                                                      weights=[4.0, 2.0, 1.0, 1.0])
        return _summary_of(ns.compiler.compile(prog, RING8(ns), passes=passes), ns)

    want, got = both(run)
    assert got == want
    assert name in [n for n, _ in got[0]]


@pytest.mark.parametrize("pipeline", ["default", "static_ecmp", "autotune", "compile_best"])
def test_default_pipelines_raise_not_implemented(pipeline):
    """The default pipelines compile as in the JAX package. The name dates
    from when some of them raised; it is kept so the test's ID stays. Now
    it checks that the default pipeline, the static-ECMP one, the autotune
    one and ``compile_best``'s default candidates compile the reference's
    plans, and that nothing is left unported."""
    def run(ns):
        prog, topo = ns.dag.paper_example(), ns.topology.paper_topology()
        if pipeline == "default":
            plan = ns.compiler.compile(prog, topo)
        elif pipeline == "autotune":
            plan = ns.compiler.compile(prog, topo, passes=ns.compiler.AUTOTUNE_PASSES)
        elif pipeline == "compile_best":
            plan = ns.compiler.compile_best(prog, topo)
        else:
            plan = ns.compiler.compile(prog, topo, passes=ns.compiler.STATIC_ECMP_PASSES)
        return _summary_of(plan, ns)

    want, got = both(run)
    assert got == want
    assert set(t_compiler.AUTOTUNE_PASSES) <= set(t_compiler.registered_passes())
    assert not hasattr(t_compiler, "UNPORTED_PASSES")


@pytest.mark.parametrize("seed", ["switch_penalty_seed", "link_penalty_seed"])
def test_seeded_route_raises_not_implemented(seed):
    """The seeded ``route`` is ported: its routes and summary are the
    reference's, and the seed moves a route off its unseeded path."""
    value = {1: 5.0} if seed == "switch_penalty_seed" else {(2, 1): 5.0}

    def run(ns, options):
        return _summary_of(ns.compiler.compile(
            ns.wordcount.wordcount_program(4, 8), ns.topology.TorusTopology(dims=(4,)),
            passes=P, options=options), ns)

    want, got = both(lambda ns: run(ns, {seed: value}))
    assert got == want
    assert "seeded" in dict(got[0])["route"]
    assert got[3] != run(NS["torch"], {})[3]


@pytest.mark.parametrize("call", ["run_default", "simulate", "simulate_timing", "flow_spec"])
def test_simulator_entry_points_raise_not_implemented(call):
    """The simulator entry points are ported: each gives the reference's
    outputs, report and flow spec on the same plan. ``run``'s default
    backend is the reference's simulator and the port's torch step on the
    card (here asked for on the CPU); both give the same outputs."""
    def run(ns):
        plan = ns.compiler.compile(ns.wordcount.wordcount_program(4, 8),
                                   ns.topology.TorusTopology(dims=(4,)), passes=P)
        inputs = {f"s{i}": np.arange(8.0) * (i + 1) for i in range(4)}
        if call == "run_default":
            kw = {"device": "cpu"} if ns is NS["torch"] else {}
            return {k: v.tolist() for k, v in plan.run(inputs, **kw).items()}
        if call == "simulate":
            sim = plan.simulate(inputs)
            return {k: v.tolist() for k, v in sim.outputs.items()}, repr(
                dataclasses.asdict(sim.report))
        return repr(dataclasses.asdict(getattr(plan, call)()))

    want, got = both(run)
    assert got == want
    if call == "run_default":
        assert got == {"OUT": (np.arange(8.0) * 10).tolist()}


@pytest.mark.parametrize("call", ["session_telemetry", "compile_best_autotune",
                                  "autotuned_preset"])
def test_autotune_and_the_telemetry_facade_raise_naming_roadmap(call):
    """Autotune and the Telemetry facade work as in the JAX package. The
    name dates from when all three raised, naming ROADMAP.md; it is kept
    so the test's ID stays. Now it checks that none raises: each compiles
    the reference's plan and tuning report, and ``Session(telemetry=True)``
    counts the compile as the reference's does."""
    def run(ns):
        p4mr = importlib.import_module(f"{ns.compiler.__name__.split('.')[0]}.p4mr")
        prog, topo = ns.dag.paper_example(), ns.topology.paper_topology()
        if call == "session_telemetry":
            sess = p4mr.Session(topo, telemetry=True)
            plan = sess.compile(prog)
            return _summary_of(plan, ns), sess.telemetry.metrics.to_dict()["counters"]
        if call == "compile_best_autotune":
            plan = ns.compiler.compile_best(prog, topo, autotune=True)
        else:
            plan = p4mr.Session(topo, options="autotuned").compile(prog)
        return _summary_of(plan, ns), plan.tuning and plan.tuning.to_dict()

    want, got = both(run)
    assert got == want
    p4mr = importlib.import_module("repro_torch.p4mr")
    assert p4mr.Session(t_topology.paper_topology(), telemetry=False).telemetry is None


def test_unknown_backend_and_jax_backend_raise_value_error():
    plan = _small_plan()
    for backend in ("jax", "numpy"):
        with pytest.raises(ValueError, match="one of 'simulate', 'torch', 'reference'"):
            plan.run({}, backend=backend)


def test_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = _small_plan()
    with pytest.raises(RuntimeError, match="CUDA.*device='cpu'"):
        plan.run({f"s{i}": np.ones(8) for i in range(4)})


@pytest.mark.parametrize("backend", ["simulate", "reference"])
def test_host_backends_refuse_a_tensor_on_a_device(backend):
    """The host backends never pull a device's tensors to the host: they
    raise, naming the backend that runs there (a meta tensor stands in for
    one on the card)."""
    plan = _small_plan()
    inputs = {f"s{i}": torch.ones(8, device="meta") for i in range(4)}
    with pytest.raises(ValueError, match="on meta; run it there with backend='torch'"):
        plan.run(inputs, backend=backend)
    cpu = {k: torch.ones(8) for k in inputs}
    np.testing.assert_array_equal(plan.run(cpu, backend=backend)["OUT"], np.full(8, 4.0))


def test_torch_backend_needs_integer_switch_ids():
    plan = t_compiler.compile(_paper_collect(NS["torch"]), t_topology.paper_topology(), passes=P)
    with pytest.raises(TypeError, match="integer switch ids"):
        plan.run({k: np.ones(1) for k in "ABC"}, backend="torch", device="cpu")
    j = NS["jax"]
    jplan = j.compiler.compile(_paper_collect(j), j.topology.paper_topology(), passes=P)
    with pytest.raises(TypeError, match="integer switch ids"):
        jplan._mesh_devices()


def test_torch_backend_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = _small_plan()
    inputs = {f"s{i}": np.ones(8) for i in range(4)}
    with pytest.raises(RuntimeError, match="CUDA.*device='cpu'"):
        plan.run(inputs, backend="torch")
    out = plan.run(inputs, backend="torch", device="cpu")
    np.testing.assert_array_equal(out["OUT"], np.full(8, 4.0))


def test_scalar_and_tensor_inputs_run_like_arrays():
    plan = _small_plan()
    arrays = {f"s{i}": np.arange(8) * (i + 1.0) for i in range(4)}
    a = plan.run(arrays, backend="torch", device="cpu")
    b = plan.run({k: torch.from_numpy(v) for k, v in arrays.items()}, backend="torch", device="cpu")
    np.testing.assert_array_equal(a["OUT"], b["OUT"])
    np.testing.assert_array_equal(a["OUT"], np.arange(8) * 10.0)
    prog = t_dag.Program()
    prog.store("A", host="d0")
    prog.store("B", host="d2")
    prog.sum("R", "A", "B")
    prog.collect("OUT", "R", sink_host="d1")
    scalar = t_compiler.compile(prog, t_topology.TorusTopology(dims=(4,)), passes=UNOPT)
    np.testing.assert_array_equal(
        scalar.run({"A": 1.5, "B": 2.0}, backend="torch", device="cpu")["OUT"], [3.5])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wordcount_tree", "s3", "s2_bf16_items", "bucket_concat"])
def test_torch_backend_on_the_card_matches_the_cpu(cuda, name):
    plan = compile_case(NS["torch"], name)
    inputs = case_inputs(name)
    dt = item_dtype("torch", name)
    cpu = plan.run(inputs, backend="torch", device="cpu", item_dtype=dt)
    card = plan.run(inputs, backend="torch", item_dtype=dt)
    for sink in cpu:
        np.testing.assert_array_equal(card[sink], cpu[sink])
