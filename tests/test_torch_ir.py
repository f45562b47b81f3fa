"""The p4mr IR, DSL, topology, placement, routing, builder and oracle of
the port against the JAX package, on the same inputs.

Both packages run in this process: their IR and compile side need no
devices. Every case builds its input with the same function from each
package's own modules (``_NS["jax"]`` / ``_NS["torch"]``) and compares the
results: printed source and AST JSON, ``DSLSyntaxError`` text and
positions, placements and routing tables, ``k_shortest_paths``, the fluent
builder's source, and ``execute_reference`` values and dtypes.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference side; the card's machine has none

from repro import p4mr as j_p4mr  # noqa: E402
from repro.core import (  # noqa: E402
    codelet as j_codelet, dag as j_dag, dsl as j_dsl, placement as j_placement,
    primitives as j_prim, routing as j_routing, scenarios as j_scenarios,
    topology as j_topology, wordcount as j_wordcount,
)
from repro_torch import p4mr as t_p4mr  # noqa: E402
from repro_torch.core import (  # noqa: E402
    codelet as t_codelet, dag as t_dag, dsl as t_dsl, placement as t_placement,
    primitives as t_prim, routing as t_routing, scenarios as t_scenarios,
    topology as t_topology, wordcount as t_wordcount,
)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

_NS = {
    "jax": types.SimpleNamespace(
        codelet=j_codelet, dag=j_dag, dsl=j_dsl, placement=j_placement, prim=j_prim,
        routing=j_routing, scenarios=j_scenarios, topology=j_topology,
        wordcount=j_wordcount, p4mr=j_p4mr,
    ),
    "torch": types.SimpleNamespace(
        codelet=t_codelet, dag=t_dag, dsl=t_dsl, placement=t_placement, prim=t_prim,
        routing=t_routing, scenarios=t_scenarios, topology=t_topology,
        wordcount=t_wordcount, p4mr=t_p4mr,
    ),
}


def both(fn):
    """``fn`` run on the JAX package and on the port: (want, got)."""
    return fn(_NS["jax"]), fn(_NS["torch"])


# ------------------------------------------------------------ DSL text --
BUCKET_CONCAT_SRC = (
    'A := store<uint_64>("ip_h1:path", 8);\n'
    "K := KEYBY(A, 2);\n"
    "B0 := BUCKET(A, 0, 2, 0, 4);\n"
    "B1 := BUCKET(A, 1, 2, 4, 4);\n"
    "R0 := SUM<4>(B0);\n"
    "R1 := SUM<4>(B1);\n"
    "R := CONCAT(R0, R1);\n"
    'OUT := COLLECT(R, "h6");\n'
)
EXTENDED_SRC = (
    'A := store<float_32>("ip_h1:data", 100);\n'
    "B := MAP(A, square);\n"
    "C := KEYBY(B, 4);\n"
    "D := MAX(C, C);\n"
    'E := COLLECT(D, "h6");\n'
)

SOURCES = {
    "paper": lambda ns: ns.dsl.PAPER_SOURCE,
    "paper_fig2": lambda ns: (EXAMPLES / "paper_fig2.p4mr").read_text(),
    "shuffle_sum": lambda ns: (EXAMPLES / "shuffle_sum.p4mr").read_text(),
    "bucket_concat": lambda ns: BUCKET_CONCAT_SRC,
    "extended": lambda ns: EXTENDED_SRC,
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_parse_ast_and_printed_source_match_jax(name):
    def run(ns):
        ast = ns.dsl.parse_ast(SOURCES[name](ns))
        prog = ns.dsl.ast_to_program(ast)
        printed = ns.dsl.program_to_source(prog)
        again = ns.dsl.program_to_source(ns.dsl.ast_to_program(ns.dsl.parse_ast(printed)))
        return ns.dsl.ast_to_json(ast), printed, again

    (want_json, want_src, want_again), (got_json, got_src, got_again) = both(run)
    assert json.loads(got_json) == json.loads(want_json)
    assert got_json == want_json
    assert got_src == want_src
    assert got_again == want_again == got_src


PROGRAMS = {
    "paper_example": lambda ns: ns.dag.paper_example(),
    "wordcount_chain": lambda ns: ns.wordcount.wordcount_program(8, 64),
    "wordcount_keyby": lambda ns: ns.wordcount.wordcount_shuffle_program(
        8, 64, num_buckets=4, weights=(1, 2, 3, 4)),
    "s1": lambda ns: ns.scenarios.scenario_program(8, "s1_host", state_width=32),
    "s2": lambda ns: ns.scenarios.scenario_program(8, "s2_in_net", state_width=32),
    "s3": lambda ns: ns.scenarios.scenario_program(8, "s3_in_net_map", state_width=32),
    "s2_shuffle": lambda ns: ns.scenarios.scenario_program(
        4, "s2_in_net", state_width=32, shuffle_buckets=4),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_builders_print_the_same_source(name):
    want, got = both(lambda ns: ns.dsl.program_to_source(PROGRAMS[name](ns)))
    assert got == want
    want, got = both(lambda ns: [n.name for n in PROGRAMS[name](ns).toposort()])
    assert got == want


BAD_SOURCES = [
    'A := store<uint_64>("no_colon_locator");',
    "A := SUM(B C);",
    'A := store<uint_64>("h1:p");\nB := SUM(A C);\n',
    "A := SUM(B);\n% := nope;\n",
    "A := SUM(B, );",
    'A := store<int_7>("h1:p");',
    "D := SUM(A, B);",  # parses; the program rejects the undefined sources
    'A := store<uint_64>("h1:p");\nB := MAP(A, nosuchfn);\n',
    'A := store<uint_64>("h1:p");\nA := SUM(A);\n',
]


@pytest.mark.parametrize("src", BAD_SOURCES)
def test_dsl_errors_and_positions_match_jax(src):
    def run(ns):
        try:
            ns.dsl.ast_to_program(ns.dsl.parse_ast(src))
        except (ns.dsl.DSLSyntaxError, ns.dag.ProgramError, ValueError) as e:
            return (type(e).__name__, str(e), getattr(e, "line", None),
                    getattr(e, "column", None), getattr(e, "token", None))
        return None

    want, got = both(run)
    assert want is not None
    assert got == want


# ------------------------------------------------- placement and routes --
TOPOLOGIES = {
    "paper": lambda ns: ns.topology.paper_topology(),
    "paper_indexed": lambda ns: ns.topology.paper_topology().as_indexed(),
    "paper_indexed8": lambda ns: ns.topology.paper_topology().as_indexed(8),
    "ring8": lambda ns: ns.topology.TorusTopology(dims=(8,)),
    "torus4x4": lambda ns: ns.topology.TorusTopology(dims=(4, 4)),
}


def _paper_programs(ns):
    shuffle = ns.dsl.ast_to_program(ns.dsl.parse_ast(SOURCES["shuffle_sum"](ns)))
    paper = ns.dag.paper_example()
    return {"paper_example": paper, "shuffle_sum": shuffle}


def _torus_programs(ns, n):
    return {
        "wordcount_chain": ns.wordcount.wordcount_program(n, 64),
        "wordcount_keyby": ns.wordcount.wordcount_shuffle_program(n, 64, num_buckets=4),
        "s2": ns.scenarios.scenario_program(n, "s2_in_net", state_width=1000),
        "s3": ns.scenarios.scenario_program(n, "s3_in_net_map", state_width=1000),
    }


def _placed_and_routed(ns, topo_name):
    topo = TOPOLOGIES[topo_name](ns)
    if topo_name.startswith("paper"):
        progs = _paper_programs(ns)
    else:
        progs = _torus_programs(ns, len(topo.switches))
    out = {}
    for name, prog in progs.items():
        for pins in ({}, {"R" if "R" in prog.nodes else prog.sinks()[0]: topo.switches[1]}):
            pl = ns.placement.place(prog, topo, pins=pins)
            rt = ns.routing.build_routes(prog, topo, pl)
            out[name, tuple(pins.items())] = (
                dict(pl.assignment), pl.total_hops,
                [(r.src_label, r.dst_label, list(r.path)) for r in rt.routes],
                rt.total_hops, rt.max_hops, rt.per_switch_transit(),
                rt.forwarding_rules(),
            )
    return out


@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_placements_and_routing_tables_match_jax(topo_name):
    want, got = both(lambda ns: _placed_and_routed(ns, topo_name))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("topo_name", sorted(TOPOLOGIES))
def test_topology_queries_match_jax(topo_name):
    def run(ns):
        topo = TOPOLOGIES[topo_name](ns)
        sw = list(topo.switches)
        return (sw, list(topo.hosts), [topo.attach_switch(h) for h in topo.hosts],
                [tuple(topo.neighbors(s)) for s in sw],
                [[topo.shortest_path(a, b) for b in sw] for a in sw],
                getattr(topo, "num_devices", None))

    want, got = both(run)
    assert got == want


@pytest.mark.parametrize("topo_name", ["paper", "torus4x4", "ring8"])
@pytest.mark.parametrize("stretch", [None, 1, 2])
def test_k_shortest_paths_match_jax(topo_name, stretch):
    def run(ns):
        topo = TOPOLOGIES[topo_name](ns)
        sw = list(topo.switches)
        return [ns.routing.k_shortest_paths(topo, a, b, 4, max_stretch=stretch)
                for a in sw for b in sw if a != b]

    want, got = both(run)
    assert got == want


# ---------------------------------------------------------------- builder --
def _wordcount_job(ns):
    job = ns.p4mr.job("wc")
    keyed = [job.store(f"s{i}", host=f"d{i}", items=16).key_by(4) for i in range(4)]
    keyed[0].reduce("SUM", *keyed[1:], label="COUNTS").collect("d3", label="OUT")
    return job


def _paper_job(ns):
    job = ns.p4mr.job("paper")
    a = job.store("A", host="h1", path="path_A")
    b = job.store("B", host="h2", path="path_B")
    c = job.store("C", host="h3", path="path_C")
    c.reduce("SUM", a.reduce("SUM", b, label="D"), label="E").collect("h6", label="OUT")
    return job


def _auto_label_job(ns):
    job = ns.p4mr.job("auto")
    s = [job.store(host=f"d{i}", items=32) for i in range(3)]
    m = s[0].map("to_bf16").reduce("MAX", s[1].map("negate"), s[2])
    m.map("from_bf16").concat(s[1]).collect("d0")
    return job


JOBS = {"wordcount": _wordcount_job, "paper": _paper_job, "auto_labels": _auto_label_job}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_builder_source_round_trip_matches_jax(name):
    def run(ns):
        job = JOBS[name](ns)
        src = job.to_source()
        back = ns.p4mr.from_source(src, name="back")
        again = ns.p4mr.from_program(back.program(), name="again")
        return src, back.to_source(), again.to_source(), [n.name for n in job.program()]

    want, got = both(run)
    assert got == want
    assert got[0] == got[1] == got[2]


# ------------------------------------------------------ reference oracle --
def _store_map_collect(ns, fns, dtype="float64", items=6):
    p = ns.dag.Program()
    p.store("A", host="h1", dtype=dtype, items=items)
    last = "A"
    for i, fn in enumerate(fns):
        p.map(f"M{i}", last, fn_name=fn)
        last = f"M{i}"
    p.collect("OUT", last, sink_host="h6")
    return p


def _kinds(ns, kind):
    p = ns.dag.Program()
    for i in range(3):
        p.store(f"s{i}", host=f"h{i + 1}", items=6)
    p.map("m1", "s1", fn_name="square")
    p.reduce("R", "s0", "m1", "s2", kind=getattr(ns.prim.ReduceKind, kind), state_width=6)
    p.collect("OUT", "R", sink_host="h6")
    return p


REF_PROGRAMS = {
    "paper_example": lambda ns: ns.dag.paper_example(),
    "square_f64": lambda ns: _store_map_collect(ns, ["square"]),
    "negate_identity": lambda ns: _store_map_collect(ns, ["negate", "identity"]),
    "bf16_round_trip": lambda ns: _store_map_collect(ns, ["to_bf16", "from_bf16"]),
    "bf16_sink": lambda ns: _store_map_collect(ns, ["square", "to_bf16"]),
    "max": lambda ns: _kinds(ns, "MAX"),
    "min": lambda ns: _kinds(ns, "MIN"),
    "count": lambda ns: _kinds(ns, "COUNT"),
    "bucket_concat": lambda ns: ns.dsl.ast_to_program(ns.dsl.parse_ast(BUCKET_CONCAT_SRC)),
    "wordcount_keyby": lambda ns: ns.wordcount.wordcount_shuffle_program(4, 6, num_buckets=2),
    "s1": lambda ns: ns.scenarios.scenario_program(4, "s1_host", state_width=6),
    "s3": lambda ns: ns.scenarios.scenario_program(4, "s3_in_net_map", state_width=6),
}


def ref_inputs(prog, seed):
    rs = np.random.RandomState(seed)
    out = {}
    for name in prog.sources():
        n = prog.nodes[name].items or 6
        out[name] = rs.randn(n) / 3.0  # thirds: float64 values float32 cannot hold
    return out


@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_execute_reference_values_and_dtypes_match_jax(name):
    inputs = ref_inputs(REF_PROGRAMS[name](_NS["jax"]), seed=sorted(REF_PROGRAMS).index(name))
    want, got = both(lambda ns: ns.codelet.execute_reference(REF_PROGRAMS[name](ns), inputs))
    assert got.keys() == want.keys()
    for sink in want:
        w, g = np.asarray(want[sink]), got[sink]
        if w.dtype.name == "bfloat16":
            # numpy has no bf16: the port returns its values as float32
            assert g.dtype == np.float32
            w = w.astype(np.float32)
        assert g.dtype == w.dtype, sink
        np.testing.assert_array_equal(g, w)


def test_square_of_a_third_goes_through_float32_as_in_jax():
    inputs = {"A": np.full(3, 1 / 3)}
    want, got = both(lambda ns: ns.codelet.execute_reference(_store_map_collect(ns, ["square"]), inputs))
    assert got["OUT"].dtype == np.float32
    assert float(got["OUT"][0]) == float(np.float32(1 / 3) * np.float32(1 / 3))
    np.testing.assert_array_equal(got["OUT"], np.asarray(want["OUT"]))


def test_reference_accepts_tensors_like_arrays():
    prog = t_scenarios.scenario_program(4, "s3_in_net_map", state_width=6)
    inputs = ref_inputs(prog, seed=5)
    a = t_codelet.execute_reference(prog, inputs)
    b = t_codelet.execute_reference(prog, {k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_array_equal(a["OUT"], b["OUT"])
    assert a["OUT"].dtype == b["OUT"].dtype == np.float32
