"""Deterministic synthetic benchmark corpus (offline stand-in for Table 3).

The paper evaluates on 38 schemastore datasets; offline, we regenerate a
corpus matching Table 3's *distribution*: per-dataset schema size (KB),
document count, and mean document size (bytes).  Schemas and documents are
built in tandem -- every generator node knows both its schema dict and how
to sample valid instances -- so documents validate by construction (spot-
checked against the naive interpreter in tests/test_corpus.py).

Key-length distribution follows the paper's observation (§4.1): 95% of
keys <= 13 chars, >98% < 32 chars, the rest longer (exercising the
semi-perfect hash long path).
"""

from __future__ import annotations

import json
import random
import string
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# (name, n_docs, schema_kb, avg_doc_bytes) -- Table 3
TABLE3 = [
    ("ansible-meta", 333, 36.1, 312), ("aws-cdk", 483, 0.7, 1145),
    ("babelrc", 794, 6.5, 140), ("clang-format", 133, 54.2, 336),
    ("cmake-presets", 967, 84.0, 2721), ("code-climate", 2484, 5.9, 282),
    ("cql2", 109, 17.9, 125), ("cspell", 981, 125.6, 817),
    ("cypress", 981, 16.0, 401), ("deno", 987, 22.4, 1018),
    ("dependabot", 967, 9.4, 403), ("draft-04", 563, 4.0, 12631),
    ("fabric-mod", 911, 11.1, 691), ("geojson", 500, 45.0, 52433),
    ("gitpod-configuration", 986, 13.1, 354), ("helm-chart-lock", 3888, 1.5, 342),
    ("importmap", 964, 0.6, 630), ("jasmine", 980, 3.6, 133),
    ("jsconfig", 981, 59.5, 177), ("jshintrc", 966, 11.8, 429),
    ("krakend", 47, 377.7, 2431), ("lazygit", 280, 87.8, 276),
    ("lerna", 985, 4.6, 172), ("nest-cli", 1025, 18.9, 290),
    ("omnisharp", 987, 13.5, 595), ("openapi", 107, 32.5, 165548),
    ("pre-commit-hooks", 985, 9.6, 549), ("pulumi", 3807, 7.7, 251),
    ("semantic-release", 794, 3.3, 460), ("stale", 961, 3.7, 466),
    ("stylecop", 983, 11.5, 567), ("tmuxinator", 382, 4.4, 628),
    ("ui5", 942, 94.1, 487), ("ui5-manifest", 611, 383.5, 2356),
    ("unreal-engine-uproject", 859, 10.6, 394), ("vercel", 710, 37.2, 406),
    ("yamllint", 984, 25.5, 351),
    ("importmap-extended", 400, 2.1, 380),  # 38th: rounds the corpus out
]

D7 = "http://json-schema.org/draft-07/schema#"
D2020 = "https://json-schema.org/draft/2020-12/schema"

_WORDS = (
    "name version type config enabled options path url target source mode "
    "value kind format level rules settings entries items files exclude "
    "include pattern timeout retries port host label tag env command args "
    "description id key output input schema plugin preset extends hooks "
    "dependencies scripts registry scope engine strict debug cache"
).split()


def _key(rng: random.Random) -> str:
    """Keys matching the paper's length distribution."""
    r = rng.random()
    base = rng.choice(_WORDS)
    if r < 0.80:
        return base  # short
    if r < 0.95:
        return base + "-" + rng.choice(_WORDS)  # <= ~13 chars mostly
    if r < 0.985:
        return base + "_" + rng.choice(_WORDS) + "_" + rng.choice(_WORDS)
    return "x-" + "-".join(rng.choice(_WORDS) for _ in range(5))  # >31 bytes


@dataclass
class _Node:
    """A schema fragment + sampler of valid instances."""

    schema: Any
    sample: Callable[[random.Random], Any]


def _string_node(rng: random.Random) -> _Node:
    r = rng.random()
    if r < 0.25:
        pat = rng.choice(["^x-", ".*", ".+", "^.{2,16}$"])
        schema = {"type": "string", "pattern": pat}

        def sample(rr):
            body = "".join(rr.choice(string.ascii_lowercase) for _ in range(rr.randint(2, 12)))
            return ("x-" + body) if pat == "^x-" else (body or "ab")

        return _Node(schema, sample)
    if r < 0.5:
        lo, hi = rng.randint(0, 3), rng.randint(8, 40)
        return _Node(
            {"type": "string", "minLength": lo, "maxLength": hi},
            lambda rr: "".join(
                rr.choice(string.ascii_lowercase) for _ in range(rr.randint(max(lo, 1), hi))
            ),
        )
    if r < 0.7:
        values = [rng.choice(_WORDS) for _ in range(rng.randint(2, 6))]
        return _Node({"enum": sorted(set(values))}, lambda rr, v=tuple(sorted(set(values))): rr.choice(v))
    return _Node({"type": "string"}, lambda rr: rr.choice(_WORDS))


def _number_node(rng: random.Random) -> _Node:
    if rng.random() < 0.5:
        lo, hi = rng.randint(-10, 0), rng.randint(1, 1000)
        return _Node(
            {"type": "integer", "minimum": lo, "maximum": hi},
            lambda rr: rr.randint(lo, hi),
        )
    return _Node({"type": "number"}, lambda rr: round(rr.uniform(-100, 100), 3))


def _bool_node(rng: random.Random) -> _Node:
    return _Node({"type": "boolean"}, lambda rr: rr.random() < 0.5)


def _array_node(rng: random.Random, item: _Node, max_items: int = 6) -> _Node:
    schema = {"type": "array", "items": item.schema}
    if rng.random() < 0.3:
        schema["maxItems"] = max_items * 2

    def sample(rr):
        return [item.sample(rr) for _ in range(rr.randint(0, max_items))]

    return _Node(schema, sample)


def _object_node(rng: random.Random, depth: int, breadth: int) -> _Node:
    n_props = rng.randint(2, breadth)
    props: Dict[str, _Node] = {}
    for _ in range(n_props):
        key = _key(rng)
        if key in props:
            continue
        props[key] = _value_node(rng, depth - 1, breadth)
    required = sorted(rng.sample(list(props), k=min(len(props), rng.randint(0, 2))))
    closed = rng.random() < 0.4
    schema: Dict[str, Any] = {
        "type": "object",
        "properties": {k: v.schema for k, v in props.items()},
    }
    if required:
        schema["required"] = required
    if closed:
        schema["additionalProperties"] = False

    def sample(rr):
        out = {}
        for k, node in props.items():
            if k in required or rr.random() < 0.55:
                out[k] = node.sample(rr)
        return out

    return _Node(schema, sample)


def _value_node(rng: random.Random, depth: int, breadth: int) -> _Node:
    if depth <= 0:
        return rng.choice([_string_node, _number_node, _bool_node])(rng)
    r = rng.random()
    if r < 0.35:
        return _object_node(rng, depth, breadth)
    if r < 0.5:
        return _array_node(rng, _value_node(rng, depth - 1, breadth))
    if r < 0.6:
        a = _object_node(rng, depth - 1, max(2, breadth // 2))
        b = _string_node(rng)
        node_schema = {"oneOf": [a.schema, b.schema]}

        def sample(rr):
            return a.sample(rr) if rr.random() < 0.5 else b.sample(rr)

        return _Node(node_schema, sample)
    return rng.choice([_string_node, _number_node, _bool_node])(rng)


@dataclass
class Dataset:
    name: str
    schema: Any
    documents: List[Any]
    dialect: str

    @property
    def schema_bytes(self) -> int:
        return len(json.dumps(self.schema).encode())

    @property
    def avg_doc_bytes(self) -> float:
        if not self.documents:
            return 0.0
        return sum(len(json.dumps(d).encode()) for d in self.documents) / len(self.documents)


def make_dataset(
    name: str,
    n_docs: int,
    schema_kb: float,
    avg_doc_bytes: float,
    *,
    seed: Optional[int] = None,
    scale: float = 1.0,
) -> Dataset:
    """Grow a schema to ~schema_kb and sample ~n_docs valid documents."""
    rng = random.Random(seed if seed is not None else hash(name) & 0xFFFF)
    dialect = D2020 if name in ("cql2", "openapi") else D7
    breadth = 6
    depth = 2 if avg_doc_bytes < 1000 else 3

    nodes: List[Tuple[str, _Node]] = []
    defs: Dict[str, Any] = {}
    root_props: Dict[str, Any] = {}
    target = schema_kb * 1024

    # shared definition exercised via many $refs (tests label/jump paths)
    shared = _object_node(rng, 1, 4)
    defs["common"] = shared.schema
    ref_count = 0

    def current_size() -> int:
        return len(json.dumps({"properties": root_props, "definitions": defs}).encode())

    while current_size() < target:
        key = _key(rng)
        if key in root_props:
            continue
        if rng.random() < 0.15 and ref_count < 8:
            root_props[key] = {"$ref": "#/definitions/common"}
            nodes.append((key, shared))
            ref_count += 1
            continue
        node = _value_node(rng, depth, breadth)
        root_props[key] = node.schema
        nodes.append((key, node))

    required = sorted(rng.sample([k for k, _ in nodes], k=min(2, len(nodes))))
    schema: Dict[str, Any] = {
        "$schema": dialect,
        "type": "object",
        "properties": root_props,
        "required": required,
    }
    if dialect == D7:
        schema["definitions"] = defs
    else:
        schema["$defs"] = {
            "common": {"$dynamicAnchor": "commonT", **defs["common"]}
        }
        # single-context dynamic reference (paper §3.4 static rewrite)
        first = next(k for k in root_props if root_props[k] == {"$ref": "#/definitions/common"})
        for k in list(root_props):
            if root_props[k] == {"$ref": "#/definitions/common"}:
                root_props[k] = {"$dynamicRef": "#commonT"}
    node_map = dict(nodes)

    def sample_doc(rr: random.Random) -> Any:
        out = {}
        for k in required:
            out[k] = node_map[k].sample(rr)
        target_bytes = avg_doc_bytes
        keys = [k for k, _ in nodes if k not in out]
        rr.shuffle(keys)
        for k in keys:
            if len(json.dumps(out).encode()) >= target_bytes:
                break
            out[k] = node_map[k].sample(rr)
        return out

    count = max(1, int(n_docs * scale))
    docs = [sample_doc(random.Random(rng.randint(0, 2**31))) for _ in range(count)]
    return Dataset(name, schema, docs, dialect)


def make_corpus(*, scale: float = 1.0, seed: int = 0) -> List[Dataset]:
    """The full 38-dataset benchmark corpus."""
    out = []
    for i, (name, n_docs, kb, avg) in enumerate(TABLE3):
        out.append(
            make_dataset(name, n_docs, kb, avg, seed=seed * 1000 + i, scale=scale)
        )
    return out
