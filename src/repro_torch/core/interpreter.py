"""A correct, non-compiling JSON Schema validator (the comparison baseline).

This walks the raw schema dictionary for every document, resolving ``$ref``
at validation time -- representative of interpreting validators such as
Python ``jsonschema`` (Table 4: AOT = no).  It intentionally performs none
of Blaze's compile-time work: no keyword tiering, no hashing, no regex
specialization, no reordering.  It shares no code with the compiled
executor, which also makes it an independent oracle for differential
testing (tests/test_differential.py).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Set, Tuple

from .doc_model import has_type, json_equal
from .schema_resolver import Dialect, SchemaResolver

__all__ = ["NaiveValidator"]


class NaiveValidator:
    """Direct schema interpretation, resolving keywords per document."""

    def __init__(self, schema: Any, resources: Optional[Dict[str, Any]] = None):
        self.schema = schema
        self.resolver = SchemaResolver(schema, resources)
        self.dialect = self.resolver.dialect

    def is_valid(self, instance: Any) -> bool:
        valid, _, _ = self._validate(self.schema, instance, self.resolver.root_base, 0)
        return valid

    # ------------------------------------------------------------------

    def _validate(
        self, schema: Any, instance: Any, base: str, depth: int
    ) -> Tuple[bool, Set[str], Set[int]]:
        """Returns (valid, evaluated property names, evaluated item indices)."""
        if depth > 512:
            raise RecursionError("schema recursion limit")
        if schema is True or schema == {}:
            return True, set(), set()
        if schema is False:
            return False, set(), set()
        s: Dict[str, Any] = schema

        from urllib.parse import urljoin

        sid = s.get("$id")
        if isinstance(sid, str) and sid:
            base = urljoin(base, sid)

        eval_props: Set[str] = set()
        eval_items: Set[int] = set()

        # --- references ---------------------------------------------------
        for kw in ("$ref", "$dynamicRef", "$recursiveRef"):
            ref = s.get(kw)
            if not isinstance(ref, str):
                continue
            if kw == "$ref":
                r = self.resolver.resolve(ref, base)
            elif kw == "$dynamicRef":
                r = self.resolver.resolve_dynamic(ref, base)
            else:
                r = self.resolver.resolve_recursive(base)
            ok, ep, ei = self._validate(r.schema, instance, r.base_uri, depth + 1)
            if not ok:
                return False, set(), set()
            eval_props |= ep
            eval_items |= ei

        # --- type/const/enum -----------------------------------------------
        t = s.get("type")
        if isinstance(t, str):
            if not has_type(instance, t):
                return False, set(), set()
        elif isinstance(t, list):
            if not any(has_type(instance, x) for x in t):
                return False, set(), set()
        if "const" in s and not json_equal(instance, s["const"]):
            return False, set(), set()
        if "enum" in s and not any(json_equal(instance, v) for v in s["enum"]):
            return False, set(), set()

        # --- numbers ---------------------------------------------------------
        if isinstance(instance, (int, float)) and not isinstance(instance, bool):
            if not self._check_number(s, instance):
                return False, set(), set()

        # --- strings ---------------------------------------------------------
        if isinstance(instance, str):
            if "minLength" in s and len(instance) < s["minLength"]:
                return False, set(), set()
            if "maxLength" in s and len(instance) > s["maxLength"]:
                return False, set(), set()
            if "pattern" in s and re.search(s["pattern"], instance, re.DOTALL) is None:
                return False, set(), set()

        # --- objects ----------------------------------------------------------
        if isinstance(instance, dict):
            ok, ep = self._check_object(s, instance, base, depth)
            if not ok:
                return False, set(), set()
            eval_props |= ep

        # --- arrays ------------------------------------------------------------
        if isinstance(instance, list):
            ok, ei = self._check_array(s, instance, base, depth)
            if not ok:
                return False, set(), set()
            eval_items |= ei

        # --- logical ---------------------------------------------------------
        for sub in s.get("allOf") or []:
            ok, ep, ei = self._validate(sub, instance, base, depth + 1)
            if not ok:
                return False, set(), set()
            eval_props |= ep
            eval_items |= ei
        any_of = s.get("anyOf")
        if isinstance(any_of, list):
            hit = False
            for sub in any_of:
                ok, ep, ei = self._validate(sub, instance, base, depth + 1)
                if ok:
                    hit = True
                    eval_props |= ep
                    eval_items |= ei
            if not hit:
                return False, set(), set()
        one_of = s.get("oneOf")
        if isinstance(one_of, list):
            passed = 0
            for sub in one_of:
                ok, ep, ei = self._validate(sub, instance, base, depth + 1)
                if ok:
                    passed += 1
                    eval_props |= ep
                    eval_items |= ei
            if passed != 1:
                return False, set(), set()
        if "not" in s:
            ok, _, _ = self._validate(s["not"], instance, base, depth + 1)
            if ok:
                return False, set(), set()
        if "if" in s and self.dialect not in (Dialect.DRAFT4, Dialect.DRAFT6):
            ok, ep, ei = self._validate(s["if"], instance, base, depth + 1)
            branch = s.get("then") if ok else s.get("else")
            if ok:
                eval_props |= ep
                eval_items |= ei
            if branch is not None:
                bok, ep2, ei2 = self._validate(branch, instance, base, depth + 1)
                if not bok:
                    return False, set(), set()
                eval_props |= ep2
                eval_items |= ei2

        # --- dependent schemas -------------------------------------------------
        if isinstance(instance, dict):
            for key, sub in self._dependent_schemas(s):
                if key in instance:
                    ok, ep, ei = self._validate(sub, instance, base, depth + 1)
                    if not ok:
                        return False, set(), set()
                    eval_props |= ep
                    eval_items |= ei

        # --- unevaluated* (after everything else) -------------------------------
        if self.dialect in (Dialect.DRAFT2019, Dialect.DRAFT2020):
            if isinstance(instance, dict) and "unevaluatedProperties" in s:
                sub = s["unevaluatedProperties"]
                for key in instance:
                    if key in eval_props or self._directly_evaluated(s, key):
                        continue
                    ok, _, _ = self._validate(sub, instance[key], base, depth + 1)
                    if not ok:
                        return False, set(), set()
                    eval_props.add(key)
                eval_props = set(instance.keys())
            if isinstance(instance, list) and "unevaluatedItems" in s:
                sub = s["unevaluatedItems"]
                for i, item in enumerate(instance):
                    if i in eval_items or i < self._direct_prefix(s):
                        continue
                    ok, _, _ = self._validate(sub, item, base, depth + 1)
                    if not ok:
                        return False, set(), set()
                eval_items = set(range(len(instance)))
        return True, eval_props, eval_items

    # ------------------------------------------------------------------

    def _check_number(self, s: Dict[str, Any], v: float) -> bool:
        if self.dialect is Dialect.DRAFT4:
            if "minimum" in s:
                if s.get("exclusiveMinimum") is True:
                    if not v > s["minimum"]:
                        return False
                elif not v >= s["minimum"]:
                    return False
            if "maximum" in s:
                if s.get("exclusiveMaximum") is True:
                    if not v < s["maximum"]:
                        return False
                elif not v <= s["maximum"]:
                    return False
        else:
            if "minimum" in s and not v >= s["minimum"]:
                return False
            if "maximum" in s and not v <= s["maximum"]:
                return False
            em = s.get("exclusiveMinimum")
            if isinstance(em, (int, float)) and not isinstance(em, bool) and not v > em:
                return False
            eM = s.get("exclusiveMaximum")
            if isinstance(eM, (int, float)) and not isinstance(eM, bool) and not v < eM:
                return False
        if "multipleOf" in s:
            from .executor import _divisible

            # shared spec-exact check: decimal multipleOf (0.01) must
            # accept decimal multiples (19.99) despite binary floats
            if not _divisible(v, s["multipleOf"]):
                return False
        return True

    def _check_object(
        self, s: Dict[str, Any], obj: Dict[str, Any], base: str, depth: int
    ) -> Tuple[bool, Set[str]]:
        evaluated: Set[str] = set()
        req = s.get("required")
        if isinstance(req, list):
            for key in req:
                if key not in obj:
                    return False, evaluated
        if "minProperties" in s and len(obj) < s["minProperties"]:
            return False, evaluated
        if "maxProperties" in s and len(obj) > s["maxProperties"]:
            return False, evaluated
        for key, deps in self._dependent_required(s):
            if key in obj:
                for d in deps:
                    if d not in obj:
                        return False, evaluated
        props = s.get("properties") or {}
        pat_props = s.get("patternProperties") or {}
        addl = s.get("additionalProperties")
        for key, value in obj.items():
            matched = False
            if key in props:
                matched = True
                ok, _, _ = self._validate(props[key], value, base, depth + 1)
                if not ok:
                    return False, evaluated
            for pat, sub in pat_props.items():
                if re.search(pat, key, re.DOTALL) is not None:
                    matched = True
                    ok, _, _ = self._validate(sub, value, base, depth + 1)
                    if not ok:
                        return False, evaluated
            if matched:
                evaluated.add(key)
            elif addl is not None:
                if addl is False:
                    return False, evaluated
                ok, _, _ = self._validate(addl, value, base, depth + 1)
                if not ok:
                    return False, evaluated
                evaluated.add(key)
        if "propertyNames" in s:
            for key in obj:
                ok, _, _ = self._validate(s["propertyNames"], key, base, depth + 1)
                if not ok:
                    return False, evaluated
        return True, evaluated

    def _check_array(
        self, s: Dict[str, Any], arr: List[Any], base: str, depth: int
    ) -> Tuple[bool, Set[int]]:
        evaluated: Set[int] = set()
        if "minItems" in s and len(arr) < s["minItems"]:
            return False, evaluated
        if "maxItems" in s and len(arr) > s["maxItems"]:
            return False, evaluated
        if s.get("uniqueItems") is True:
            for i in range(len(arr)):
                for j in range(i + 1, len(arr)):
                    if json_equal(arr[i], arr[j]):
                        return False, evaluated
        prefix, tail = self._split_items(s)
        for i, sub in enumerate(prefix):
            if i >= len(arr):
                break
            ok, _, _ = self._validate(sub, arr[i], base, depth + 1)
            if not ok:
                return False, evaluated
            evaluated.add(i)
        if tail is not None:
            for i in range(len(prefix), len(arr)):
                if tail is False:
                    return False, evaluated
                ok, _, _ = self._validate(tail, arr[i], base, depth + 1)
                if not ok:
                    return False, evaluated
                evaluated.add(i)
        if "contains" in s and self.dialect is not Dialect.DRAFT4:
            min_c = s.get("minContains", 1)
            max_c = s.get("maxContains")
            if self.dialect in (Dialect.DRAFT6, Dialect.DRAFT7):
                min_c, max_c = 1, None
            count = 0
            for i, item in enumerate(arr):
                ok, _, _ = self._validate(s["contains"], item, base, depth + 1)
                if ok:
                    count += 1
                    evaluated.add(i)
            if count < min_c or (max_c is not None and count > max_c):
                return False, evaluated
        return True, evaluated

    # ------------------------------------------------------------------

    def _split_items(self, s: Dict[str, Any]):
        if self.dialect in (Dialect.DRAFT2019, Dialect.DRAFT2020):
            prefix = s.get("prefixItems") or []
            items = s.get("items")
            if self.dialect is Dialect.DRAFT2019 and isinstance(items, list):
                return items, s.get("additionalItems")
            return list(prefix), items
        items = s.get("items")
        if isinstance(items, list):
            return items, s.get("additionalItems")
        return [], items

    def _dependent_required(self, s: Dict[str, Any]):
        out = []
        dr = s.get("dependentRequired")
        if isinstance(dr, dict):
            out.extend((k, v) for k, v in dr.items() if isinstance(v, list))
        legacy = s.get("dependencies")
        if isinstance(legacy, dict):
            out.extend((k, v) for k, v in legacy.items() if isinstance(v, list))
        return out

    def _dependent_schemas(self, s: Dict[str, Any]):
        out = []
        ds = s.get("dependentSchemas")
        if isinstance(ds, dict):
            out.extend(ds.items())
        legacy = s.get("dependencies")
        if isinstance(legacy, dict):
            out.extend((k, v) for k, v in legacy.items() if not isinstance(v, list))
        return out

    def _directly_evaluated(self, s: Dict[str, Any], key: str) -> bool:
        if key in (s.get("properties") or {}):
            return True
        for pat in s.get("patternProperties") or {}:
            if re.search(pat, key, re.DOTALL) is not None:
                return True
        return "additionalProperties" in s

    def _direct_prefix(self, s: Dict[str, Any]) -> int:
        prefix, tail = self._split_items(s)
        if tail is not None:
            return 1 << 30
        return len(prefix)
