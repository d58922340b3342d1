"""Shared example endpoint schemas for the multi-tenant gateway.

One copy serves both the demo (``examples/api_gateway.py``) and the
mixed-traffic benchmark (``benchmarks/registry.py``) so the benchmark
always measures exactly the schemas the demo serves.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["GATEWAY_SCHEMAS"]

GATEWAY_SCHEMAS: Dict[str, Any] = {
    "complete": {
        "type": "object",
        "required": ["prompt"],
        "additionalProperties": False,
        "properties": {
            "prompt": {"type": "string", "minLength": 1, "maxLength": 65536},
            "max_tokens": {"type": "integer", "minimum": 1, "maximum": 4096},
            "temperature": {"type": "number", "minimum": 0, "maximum": 2},
            "stop": {"type": "array", "items": {"type": "string"}, "maxItems": 4},
        },
    },
    "chat": {
        "type": "object",
        "required": ["messages"],
        "additionalProperties": False,
        "properties": {
            "messages": {
                "type": "array",
                "minItems": 1,
                "maxItems": 16,
                "items": {
                    "type": "object",
                    "required": ["role", "content"],
                    "additionalProperties": False,
                    "properties": {
                        "role": {"enum": ["system", "user", "assistant"]},
                        "content": {"type": "string", "minLength": 1},
                    },
                },
            },
            "max_tokens": {"type": "integer", "minimum": 1, "maximum": 4096},
        },
    },
    "embed": {
        "type": "object",
        "required": ["input"],
        "additionalProperties": False,
        "properties": {
            "input": {"type": "string", "minLength": 1, "maxLength": 8192},
            "dimensions": {"type": "integer", "minimum": 8, "maximum": 4096},
        },
    },
    "moderate": {
        "type": "object",
        "required": ["input", "category"],
        "additionalProperties": False,
        "properties": {
            "input": {"type": "string", "minLength": 1},
            "category": {"enum": ["toxicity", "violence", "spam"]},
        },
    },
    # tagged-union endpoint: the most common real-world API-payload shape
    # for logical applicators -- batchable via assertion-group circuits
    # (DESIGN.md §10), previously a guaranteed sequential fallback
    "charge": {
        "type": "object",
        "required": ["amount", "method"],
        "properties": {
            "amount": {"type": "integer", "minimum": 1, "maximum": 10_000_00},
            "currency": {"enum": ["usd", "eur", "gbp"]},
            "method": {
                "type": "object",
                "required": ["kind"],
                "properties": {"kind": {"enum": ["card", "bank", "wallet"]}},
                "oneOf": [
                    {
                        "properties": {
                            "kind": {"const": "card"},
                            "number": {"type": "string", "minLength": 12, "maxLength": 19},
                            "cvv": {"type": "string", "minLength": 3, "maxLength": 4},
                        },
                        "required": ["number", "cvv"],
                    },
                    {
                        "properties": {
                            "kind": {"const": "bank"},
                            "iban": {"type": "string", "minLength": 15, "maxLength": 34},
                        },
                        "required": ["iban"],
                    },
                    {
                        "properties": {
                            "kind": {"const": "wallet"},
                            "wallet_id": {"type": "string", "pattern": "^w-"},
                        },
                        "required": ["wallet_id"],
                    },
                ],
            },
        },
    },
}
