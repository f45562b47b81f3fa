"""Parser for the paper's p4mr surface syntax (§5.2).

The paper implements a "raw code compiler" with flex & bison that parses

    A := store < uint_64 > ("ip_h1:path_A");
    B := store < uint_64 > ("ip_h2:path_B");
    C := store < uint_64 > ("ip_h3:path_C");
    D := SUM(A, B);
    E := SUM(C, D);

into a JSON AST, which a separate pass converts to a DAG. We reproduce the
same two stages with a hand-written lexer + recursive-descent parser:
``parse_ast`` emits the JSON-able AST (label, function type, parameters —
matching the paper's description), ``ast_to_program`` builds the
``dag.Program``. Extensions beyond the paper's grammar (MAP/KEYBY/COLLECT,
more dtypes, more reduce kinds) use the same call syntax.

KEYBY end to end (the in-network shuffle)
-----------------------------------------
``K := KEYBY(S, B);`` declares the paper's mapper→reducer hash routing:
S's items are bucketed into B key-space slices (bucket = key // slice
width, order-preserving; per-bucket skew weights are settable via the
``Program.key_by`` API). The surface form is just the annotation — the
realization happens downstream:

1. **parse**   — KEYBY becomes a ``primitives.KeyBy`` node (this module).
2. **lower**   — the compiler's ``lower-shuffle`` pass expands every
   KEYBY-fed reduce into per-bucket ``BUCKET`` edges (``ShuffleBucket``)
   and per-bucket reducers, pinned to switches the §3 CostModel picks
   under per-switch memory budgets; the reduce's label survives as a
   ``CONCAT`` reassembling bucket order (see ``repro_torch.shuffle.lower``).
3. **route**   — each bucket edge is routed individually
   (``core.routing.build_routes``, queue-aware ECMP tie-breaking), so the
   shuffle's fan-out is visible in ``CompiledPlan.routes``, the packet
   simulator's per-switch queues, and ``shuffle.plan_shuffle`` stats.
4. **execute** — the torch backend ships each bucket over its ``ppermute``
   hop sequence; the fused device-mesh equivalent is one capacity-sized
   ``all_to_all`` built on the ``hash_partition`` kernel
   (``repro_torch.shuffle.spmd``), which word-count's token path uses.

``BUCKET(src, bucket, num_buckets, offset, width)`` and
``CONCAT(srcs...)`` exist in the surface syntax so optimized (lowered)
programs still print and re-parse via ``program_to_source``.
"""
from __future__ import annotations

import json
import re
import warnings
from typing import Any, NamedTuple

from repro_torch.core import dag, primitives as prim

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<assign>:=)
  | (?P<lt><) | (?P<gt>>)
  | (?P<lparen>\() | (?P<rparen>\)) | (?P<comma>,) | (?P<semi>;)
  | (?P<string>"[^"]*")
  | (?P<int>\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    """,
    re.VERBOSE,
)

# dtype spellings: the paper writes ``uint_64``; normalize to numpy-ish.
_DTYPE_ALIASES = {
    "uint_64": "uint64",
    "uint_32": "uint32",
    "int_32": "int32",
    "float_32": "float32",
    "bf_16": "bfloat16",
    "float_64": "float64",
}


class DSLSyntaxError(ValueError):
    """Syntax error with source position.

    ``line``/``column`` are 1-based coordinates of the offending token
    (or of the unlexable character for lex errors) and ``token`` is its
    text — so frontends (``repro_torch.p4mr.from_source``, editors, tests) can
    point at the mistake instead of quoting an offset.
    """

    def __init__(
        self,
        message: str,
        *,
        line: int | None = None,
        column: int | None = None,
        token: str | None = None,
    ):
        if line is not None:
            message = f"{message} (line {line}, column {column})"
        super().__init__(message)
        self.line = line
        self.column = column
        self.token = token


class Token(NamedTuple):
    kind: str
    value: str
    line: int
    column: int


def _lex(src: str) -> list[Token]:
    out: list[Token] = []
    pos, line, col = 0, 1, 1
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            bad = src[pos : pos + 20].split("\n", 1)[0] or src[pos]
            raise DSLSyntaxError(
                f"lex error: unexpected {bad!r}", line=line, column=col, token=bad
            )
        text = m.group()
        if m.lastgroup != "ws":
            out.append(Token(m.lastgroup, text, line, col))
        newlines = text.count("\n")
        if newlines:
            line += newlines
            col = len(text) - text.rfind("\n")
        else:
            col += len(text)
        pos = m.end()
    out.append(Token("eof", "", line, col))
    return out


class _Parser:
    def __init__(self, tokens: list[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def eat(self, kind: str) -> str:
        tok = self.toks[self.i]
        if tok.kind != kind:
            raise DSLSyntaxError(
                f"expected {kind}, got {tok.kind} {tok.value!r}",
                line=tok.line, column=tok.column, token=tok.value,
            )
        self.i += 1
        return tok.value

    def parse(self) -> list[dict[str, Any]]:
        stmts = []
        idx = 0
        while self.peek()[0] != "eof":
            stmts.append(self.statement(idx))
            idx += 1
        return stmts

    def statement(self, idx: int) -> dict[str, Any]:
        label = self.eat("ident")
        self.eat("assign")
        fn = self.eat("ident")
        node: dict[str, Any] = {"index": idx, "label": label, "function": fn.lower(), "params": {}}
        if fn.lower() == "store":
            # store < dtype > ("host:path" [, items])
            self.eat("lt")
            dtype = self.eat("ident")
            self.eat("gt")
            self.eat("lparen")
            loc_tok = self.peek()
            locator = self.eat("string").strip('"')
            if ":" not in locator:
                raise DSLSyntaxError(
                    f"store locator must be 'host:path', got {locator!r}",
                    line=loc_tok.line, column=loc_tok.column, token=loc_tok.value,
                )
            host, path = locator.split(":", 1)
            items = 0
            if self.peek()[0] == "comma":
                self.eat("comma")
                items = int(self.eat("int"))
            self.eat("rparen")
            node["params"] = {
                "dtype": _DTYPE_ALIASES.get(dtype, dtype),
                "host": host,
                "path": path,
                "items": items,
            }
        else:
            # FN(arg, arg, ...) where args are idents / strings / ints.
            # Reduce kinds take an optional state width: SUM<64>(A, B).
            state_width = None
            if self.peek()[0] == "lt":
                self.eat("lt")
                state_width = int(self.eat("int"))
                self.eat("gt")
            self.eat("lparen")
            args: list[Any] = []
            while self.peek()[0] != "rparen":
                tok = self.peek()
                if tok.kind == "ident":
                    args.append(self.eat("ident"))
                elif tok.kind == "string":
                    args.append(self.eat("string").strip('"'))
                elif tok.kind == "int":
                    args.append(int(self.eat("int")))
                else:
                    raise DSLSyntaxError(
                        f"bad argument token {tok.kind} {tok.value!r}",
                        line=tok.line, column=tok.column, token=tok.value,
                    )
                if self.peek()[0] != "rparen":
                    self.eat("comma")  # commas are mandatory between args
            self.eat("rparen")
            node["params"] = {"args": args}
            if state_width is not None:
                node["params"]["state_width"] = state_width
        self.eat("semi")
        return node


def parse_ast(src: str) -> list[dict[str, Any]]:
    """Source text → JSON-able AST (paper: flex/bison → json AST)."""
    return _Parser(_lex(src)).parse()


def ast_to_json(ast: list[dict[str, Any]]) -> str:
    return json.dumps(ast, indent=2)


_REDUCE_KINDS = {
    "sum": prim.ReduceKind.SUM,
    "max": prim.ReduceKind.MAX,
    "min": prim.ReduceKind.MIN,
    "count": prim.ReduceKind.COUNT,
}


def ast_to_program(ast: list[dict[str, Any]]) -> dag.Program:
    """AST → dependency DAG (paper: dependency graph parser)."""
    p = dag.Program()
    for stmt in ast:
        label, fn, params = stmt["label"], stmt["function"], stmt["params"]
        if fn == "store":
            p.store(label, host=params["host"], path=params["path"],
                    dtype=params["dtype"], items=params.get("items", 0))
        elif fn in _REDUCE_KINDS:
            args = [str(a) for a in params["args"]]
            if not args:
                raise dag.ProgramError(f"{fn.upper()}() needs at least one source")
            p.reduce(label, *args, kind=_REDUCE_KINDS[fn],
                     state_width=params.get("state_width", 1))
        elif fn == "map":
            args = params["args"]
            if len(args) != 2:
                raise dag.ProgramError("MAP(src, fn_name) takes exactly 2 args")
            p.map(label, str(args[0]), fn_name=str(args[1]))
        elif fn == "keyby":
            args = params["args"]
            if len(args) != 2:
                raise dag.ProgramError("KEYBY(src, num_buckets) takes exactly 2 args")
            p.key_by(label, str(args[0]), num_buckets=int(args[1]))
        elif fn == "bucket":
            args = params["args"]
            if len(args) != 5:
                raise dag.ProgramError(
                    "BUCKET(src, bucket, num_buckets, offset, width) takes exactly 5 args"
                )
            p.bucket(label, str(args[0]), bucket=int(args[1]), num_buckets=int(args[2]),
                     offset=int(args[3]), width=int(args[4]))
        elif fn == "concat":
            args = [str(a) for a in params["args"]]
            if not args:
                raise dag.ProgramError("CONCAT() needs at least one source")
            p.concat(label, *args)
        elif fn == "collect":
            args = params["args"]
            if len(args) != 2:
                raise dag.ProgramError("COLLECT(src, sink_host) takes exactly 2 args")
            p.collect(label, str(args[0]), sink_host=str(args[1]))
        else:
            raise dag.ProgramError(f"unknown operation {fn!r}")
    p.validate()
    return p


def compile_source(src: str) -> dag.Program:
    """Deprecated one-shot DSL text → validated Program.

    Use ``repro_torch.p4mr.from_source(src)`` (the framework frontend, which
    also yields the fluent ``Job`` handle) — or compose
    ``ast_to_program(parse_ast(src))`` when only the Program is wanted.
    """
    warnings.warn(
        "repro_torch.core.dsl.compile_source is deprecated; use "
        "repro_torch.p4mr.from_source(src) (then .program()) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return ast_to_program(parse_ast(src))


_DTYPE_UNALIASES = {v: k for k, v in _DTYPE_ALIASES.items()}


def program_to_source(program: dag.Program) -> str:
    """Program → DSL text (inverse of ``compile_source`` up to spelling).

    The compiler's optimization passes rewrite the DAG; printing the result
    back as surface syntax makes optimized programs inspectable and lets
    tests assert the round trip ``compile_source(program_to_source(p))``
    preserves structure. Nodes are emitted in topological order.
    """
    lines = []
    for n in program.toposort():
        if isinstance(n, prim.Store):
            dtype = _DTYPE_UNALIASES.get(n.dtype, n.dtype)
            items = f", {n.items}" if n.items else ""
            lines.append(f'{n.name} := store<{dtype}>("{n.host}:{n.path}"{items});')
        elif isinstance(n, prim.MapFn):
            lines.append(f"{n.name} := MAP({n.src}, {n.fn_name});")
        elif isinstance(n, prim.KeyBy):
            # declared skew weights are API-only (floats have no surface
            # syntax); the bucket count round-trips
            lines.append(f"{n.name} := KEYBY({n.src}, {n.num_buckets});")
        elif isinstance(n, prim.ShuffleBucket):
            lines.append(
                f"{n.name} := BUCKET({n.src}, {n.bucket}, {n.num_buckets}, "
                f"{n.offset}, {n.width});"
            )
        elif isinstance(n, prim.Concat):
            lines.append(f"{n.name} := CONCAT({', '.join(n.srcs)});")
        elif isinstance(n, prim.Reduce):
            width = f"<{n.state_width}>" if n.state_width != 1 else ""
            lines.append(f"{n.name} := {n.kind.value.upper()}{width}({', '.join(n.srcs)});")
        elif isinstance(n, prim.Collect):
            lines.append(f'{n.name} := COLLECT({n.src}, "{n.sink_host}");')
        else:  # pragma: no cover - future node types
            raise dag.ProgramError(f"unprintable node type {type(n).__name__}")
    return "\n".join(lines) + "\n"


PAPER_SOURCE = """
A := store<uint_64>("ip_h1:path_A");
B := store<uint_64>("ip_h2:path_B");
C := store<uint_64>("ip_h3:path_C");
D := SUM(A, B);
E := SUM(C, D);
"""
