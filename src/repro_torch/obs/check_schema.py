"""Minimal JSON-schema validator + CLI for the metrics schema (copy of
``repro.obs.check_schema``).

The exporters (live serving through ``repro_torch.launch.serve``, the
chip smoke run) must all emit the SAME metrics shape;
``repro_torch/obs/metrics_schema.json`` (a copy of the reference's
``benchmarks/metrics_schema.json``, held equal by a test) pins it and this
module enforces it, in tests and as
``python -m repro_torch.obs.check_schema <file> <schema> [--key metrics]``
so an exporter cannot silently drift.

Implements the subset of JSON Schema the metrics schema uses (no external
dependency): ``type`` (object / array / string / number / integer /
boolean), ``required``, ``properties``, ``additionalProperties`` (a
sub-schema applied to unlisted keys, or ``false`` to forbid them),
``items``, ``enum``, ``minimum``/``maximum``.
"""
from __future__ import annotations

import argparse
import json
import numbers
import sys
from pathlib import Path

SCHEMA_PATH = Path(__file__).with_name("metrics_schema.json")


def load_schema() -> dict:
    """The port's copy of the metrics schema."""
    with open(SCHEMA_PATH) as f:
        return json.load(f)

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value, typ: str) -> bool:
    if typ == "number":
        return isinstance(value, numbers.Real) and not isinstance(value, bool)
    if typ == "integer":
        return (isinstance(value, numbers.Integral)
                and not isinstance(value, bool))
    return isinstance(value, _TYPES[typ])


def validate(value, schema: dict, path: str = "$") -> list[str]:
    """Returns a list of human-readable violations (empty == valid)."""
    errs: list[str] = []
    typ = schema.get("type")
    if typ is not None:
        types = typ if isinstance(typ, list) else [typ]
        if not any(_type_ok(value, t) for t in types):
            return [f"{path}: expected {typ}, got "
                    f"{type(value).__name__} ({value!r:.60})"]
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path}: {value!r} not in {schema['enum']}")
    if isinstance(value, numbers.Real) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errs.append(f"{path}: {value} < minimum {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errs.append(f"{path}: {value} > maximum {schema['maximum']}")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                errs.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties", True)
        for k, v in value.items():
            if k in props:
                errs.extend(validate(v, props[k], f"{path}.{k}"))
            elif extra is False:
                errs.append(f"{path}: unexpected key {k!r}")
            elif isinstance(extra, dict):
                errs.extend(validate(v, extra, f"{path}.{k}"))
    if isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            errs.extend(validate(v, schema["items"], f"{path}[{i}]"))
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a metrics JSON file against a schema")
    ap.add_argument("file", help="JSON file to validate")
    ap.add_argument("schema", help="schema JSON file")
    ap.add_argument("--key", default=None,
                    help="validate only this top-level key of FILE "
                         "(e.g. 'metrics'); nested keys via dots")
    args = ap.parse_args(argv)
    with open(args.file) as f:
        doc = json.load(f)
    with open(args.schema) as f:
        schema = json.load(f)
    if args.key:
        for k in args.key.split("."):
            if not isinstance(doc, dict) or k not in doc:
                print(f"FAIL: {args.file} has no key {args.key!r}")
                return 1
            doc = doc[k]
    errs = validate(doc, schema)
    if errs:
        print(f"FAIL: {args.file} does not match {args.schema}:")
        for e in errs[:20]:
            print("  -", e)
        if len(errs) > 20:
            print(f"  ... and {len(errs) - 20} more")
        return 1
    print(f"OK: {args.file}"
          + (f" [{args.key}]" if args.key else "")
          + f" matches {args.schema}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
