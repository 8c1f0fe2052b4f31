"""Textual ADIL front end (paper §2 grammar, Fig. 3 style).

The paper's first contribution is ADIL itself — a dataflow language of
assignment statements.  This parser accepts the tensor-world dialect and
produces a validated :class:`~repro_torch.core.ir.Plan` through the same
:class:`~repro_torch.core.adil.Analysis` class the embedded DSL uses, so a
script and the equivalent Python build the identical logical plan.

Grammar (recursive descent; ``<ho-expr>`` covers the paper's map/reduce):

    script      := "USE" ident ";" "create" "analysis" ident "as" "{" stmt* "}"
    stmt        := ident ":=" expr ";"   |   "store" "(" ident ")" ";"
    expr        := input-expr | call-expr | ho-expr
    input-expr  := "input" "(" shape "," dtype ["," "dims" "=" list] ")"
    call-expr   := ident "(" ident ("," kwarg)* ")"
    ho-expr     := ("map"|"reduce") "(" ident "," ident "->" call-expr ")"
    kwarg       := ident "=" value
    value       := number | string | bool | list | ident

Example::

    USE demoDB;
    create analysis tiny as {
      toks := input([2, 16], int32, dims=[batch, seq]);
      h    := embed(toks, vocab=64, embed=32, pp=[embed], dtype=float32);
      h2   := attention(h, heads=4, kv_heads=2, head_dim=8, embed=32,
                        pp=[attn]);
      out  := mlp(h2, ffn=64, embed=32, pp=[mlp]);
      store(out);
    }
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional

from .adil import Analysis, Var
from .ir import FunctionCatalog, Plan, TensorT, ValidationError

_TOKEN = re.compile(r"""
    (?P<ws>\s+|//[^\n]*)
  | (?P<num>-?\d+\.\d+|-?\d+)
  | (?P<str>"[^"]*"|'[^']*')
  | (?P<assign>:=)
  | (?P<arrow>->)
  | (?P<punct>[{}()\[\],;=])
  | (?P<ident>[A-Za-z_][\w.\-]*)
""", re.VERBOSE)


def _tokenize(src: str):
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if not m:
            raise ValidationError(f"ADIL: bad character at {src[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        out.append((m.lastgroup, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, toks, catalog: FunctionCatalog):
        self.toks = toks
        self.i = 0
        self.catalog = catalog
        self.analysis: Optional[Analysis] = None
        self.env: dict = {}

    # -- token helpers -------------------------------------------------------
    def peek(self):
        return self.toks[self.i]

    def next(self, kind=None, value=None):
        k, v = self.toks[self.i]
        if (kind and k != kind) or (value is not None and v != value):
            raise ValidationError(
                f"ADIL: expected {value or kind}, got {v!r} (token {self.i})")
        self.i += 1
        return v

    def accept(self, value):
        if self.peek()[1] == value:
            self.i += 1
            return True
        return False

    # -- grammar -------------------------------------------------------------
    def script(self) -> Analysis:
        self.next("ident", "USE")
        self.next("ident")                       # polystore instance alias
        self.next("punct", ";")
        self.next("ident", "create")
        self.next("ident", "analysis")
        name = self.next("ident")
        self.next("ident", "as")
        self.next("punct", "{")
        self.analysis = Analysis(name, self.catalog)
        while not self.accept("}"):
            self.stmt()
        if not self.analysis._stores:
            raise ValidationError(f"analysis {name!r} has no store statements")
        self.analysis.plan.set_outputs(*self.analysis._stores)
        return self.analysis

    def _lookup(self, name: str) -> Var:
        if name not in self.env:
            raise ValidationError(f"ADIL: unknown variable {name!r}")
        return self.env[name]

    def stmt(self):
        if self.peek()[1] == "store":
            self.next("ident", "store")
            self.next("punct", "(")
            var = self._lookup(self.next("ident"))
            self.next("punct", ")")
            self.next("punct", ";")
            self.analysis.store(var)
            return
        lhs = self.next("ident")
        self.next("assign")
        self.env[lhs] = self.expr(lhs)
        self.next("punct", ";")

    def expr(self, lhs: str) -> Var:
        head = self.next("ident")
        self.next("punct", "(")
        if head in ("table", "graph", "corpus"):
            return self._store_decl(head, lhs)
        if head == "input":
            shape = tuple(self.value())
            self.next("punct", ",")
            dtype = self.next("ident")
            dims = ()
            while self.accept(","):
                key = self.next("ident")
                self.next("punct", "=")
                if key != "dims":
                    raise ValidationError("input(): only dims= allowed")
                dims = tuple(self.value())
            self.next("punct", ")")
            return self.analysis.input(
                lhs, TensorT(shape, dtype, dims))
        if head in ("map", "reduce"):
            coll = self._lookup(self.next("ident"))
            self.next("punct", ",")
            local = self.next("ident")
            self.next("arrow")
            sub = self._lambda_body(local)
            self.next("punct", ")")
            if head == "map":
                return self.analysis.map(coll, sub)
            raise ValidationError("reduce literals need a python fn; use the "
                                  "embedded DSL for reduce")
        # ordinary call: first positional args are prior vars
        args, kwargs = [], {}
        while self.peek()[1] != ")":
            k, v = self.peek()
            if k == "ident" and self.toks[self.i + 1][1] == "=":
                key = self.next("ident")
                self.next("punct", "=")
                kwargs[key] = self.value()
            else:
                args.append(self._lookup(self.next("ident")))
            self.accept(",")
        self.next("punct", ")")
        return self.analysis.op(head, *args, **kwargs)

    def _store_decl(self, kind: str, lhs: str) -> Var:
        """Native store types (paper §2.1): ``table(rows=N, cols=[[name,
        dtype], ...])``, ``graph(nodes=N, edges=E)``, ``corpus(docs=D,
        vocab=V, postings=P)`` declare typed tri-store inputs."""
        kwargs = {}
        while self.peek()[1] != ")":
            key = self.next("ident")
            self.next("punct", "=")
            kwargs[key] = self.value()
            self.accept(",")
        self.next("punct", ")")
        try:
            if kind == "table":
                cols = tuple((str(c[0]), str(c[1]))
                             for c in kwargs["cols"])
                return self.analysis.table(lhs, kwargs["rows"], cols)
            if kind == "graph":
                return self.analysis.graph(
                    lhs, kwargs["nodes"], kwargs["edges"],
                    kwargs.get("weighted", False))
            return self.analysis.corpus(
                lhs, kwargs["docs"], kwargs["vocab"], kwargs["postings"])
        except (KeyError, IndexError, TypeError) as e:
            raise ValidationError(f"ADIL: bad {kind}() declaration: {e}")

    def _lambda_body(self, local: str) -> Plan:
        """`x -> op(x, k=v, ...)` becomes a single-op subplan."""
        op_name = self.next("ident")
        self.next("punct", "(")
        sub = Plan(f"lambda_{op_name}")
        # the element type is inferred later by map's validator; use a
        # placeholder tensor type that infer_types overwrites
        sub.add_input(local, TensorT((), "float32"))
        kwargs = {}
        saw_local = False
        while self.peek()[1] != ")":
            k, v = self.peek()
            if k == "ident" and self.toks[self.i + 1][1] == "=":
                key = self.next("ident")
                self.next("punct", "=")
                kwargs[key] = self.value()
            else:
                nm = self.next("ident")
                if nm != local:
                    raise ValidationError(
                        f"lambda may only reference {local!r}")
                saw_local = True
            self.accept(",")
        self.next("punct", ")")
        if not saw_local:
            raise ValidationError("lambda body must use its argument")
        nid = sub.add(op_name, [local], kwargs)
        sub.set_outputs(nid)
        return sub

    def value(self) -> Any:
        k, v = self.peek()
        if k == "num":
            self.i += 1
            return float(v) if "." in v else int(v)
        if k == "str":
            self.i += 1
            return v[1:-1]
        if v == "[":
            self.i += 1
            out = []
            while not self.accept("]"):
                out.append(self.value())
                self.accept(",")
            return out
        if k == "ident":
            self.i += 1
            if v in ("true", "True"):
                return True
            if v in ("false", "False"):
                return False
            return v  # bare identifiers: dtypes, dim names, pp path parts
        raise ValidationError(f"ADIL: bad value {v!r}")


def parse_adil(src: str, catalog: FunctionCatalog) -> Analysis:
    """Parse an ADIL script into a validated Analysis.

    Convention: list-valued ``pp=[a, b]`` kwargs become param-path tuples,
    ``dims=[batch, seq]`` become dim-name tuples.
    """
    parser = _Parser(_tokenize(src), catalog)
    analysis = parser.script()
    # normalize: pp/dims lists of idents -> tuples of strings
    for node in analysis.plan.topo():
        for key in ("pp",):
            if key in node.attrs and isinstance(node.attrs[key], list):
                node.attrs[key] = tuple(str(x) for x in node.attrs[key])
    from .ir import infer_types
    infer_types(analysis.plan, catalog)
    return analysis


# canonical short name: a script and the equivalent embedded-DSL build
# produce the identical logical plan — and therefore the identical
# ``plan_id`` (see tests/test_plan_pipeline.py round-trip)
parse = parse_adil
