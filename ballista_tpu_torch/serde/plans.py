"""Plan and expression wire format, JSON (port of
ballista_tpu/serde/plans.py, host only).

Reference parity: `BallistaCodec` + ballista.proto's logical/physical plan
messages (`core/src/serde/mod.rs:84`, `core/proto/ballista.proto:32-79`) —
the scheduler receives serialized plans from clients and ships serialized
stage plans to executors. A JSON tree over the dataclass AST serves the
same role for the multi-host control plane (schemas travel as field lists;
string dictionaries are data, not plan, and are re-derived at bind time).
"""

from __future__ import annotations

import dataclasses
import decimal
import json
from typing import Any

from .. import exprs as E
from ..exec.aggregate import AggExpr
from ..planner import logical as L
from ..schema import DataType, Field, Schema, TypeKind

_EXPR_TYPES = {
    cls.__name__: cls for cls in [
        E.Col, E.Lit, E.IntervalLit, E.BinOp, E.Not, E.Neg, E.IsNull, E.Cast,
        E.Case, E.InList, E.Like, E.Between, E.Alias, E.ScalarFn,
    ]
}
_PLAN_TYPES = {
    cls.__name__: cls for cls in [
        L.TableScan, L.Filter, L.Projection, L.Aggregate, L.Sort, L.Limit,
        L.Join, L.Distinct, L.Union, L.Window, L.OneRow,
    ]
}


def _encode_dtype(dt: DataType) -> dict:
    return {"kind": dt.kind.value, "precision": dt.precision, "scale": dt.scale}


def _decode_dtype(d: dict) -> DataType:
    return DataType(TypeKind(d["kind"]), d["precision"], d["scale"])


def _encode_schema(s: Schema) -> list:
    return [{"name": f.name, "dtype": _encode_dtype(f.dtype),
             "nullable": f.nullable} for f in s.fields]


def _decode_schema(items: list) -> Schema:
    return Schema(tuple(Field(i["name"], _decode_dtype(i["dtype"]),
                              i["nullable"]) for i in items))


def _enc(v: Any) -> Any:
    if isinstance(v, E.Expr):
        return encode_expr(v)
    if isinstance(v, L.LogicalPlan):
        return encode_plan(v)
    if isinstance(v, AggExpr):
        return {"@agg": True, "kind": v.kind,
                "arg": encode_expr(v.arg) if v.arg is not None else None,
                "alias": v.alias, "distinct": v.distinct,
                "arg2": encode_expr(v.arg2) if v.arg2 is not None else None,
                "frac": v.frac,
                # set only on lowered plans; a logical plan's document is
                # the reference's
                **({"wide": True} if v.wide else {}),
                **({"carried": True} if v.carried else {}),
                **({"shown": v.shown} if v.shown else {})}
    from ..exec.window import WindowFnSpec
    if isinstance(v, WindowFnSpec):
        return {"@winspec": True, "kind": v.kind,
                "arg": encode_expr(v.arg) if v.arg is not None else None,
                "partition_by": [_enc(e) for e in v.partition_by],
                "order_by": [[_enc(e), asc, nf]
                             for e, asc, nf in v.order_by],
                "offset": v.offset, "alias": v.alias,
                "frame": list(v.frame) if v.frame is not None else None}
    if isinstance(v, DataType):
        return {"@dtype": _encode_dtype(v)}
    if isinstance(v, decimal.Decimal):
        # a folded scalar subquery's decimal result (Q15, Q22); the
        # reference's encoder raises TypeError on it
        return {"@decimal": str(v)}
    if isinstance(v, Schema):
        return {"@schema": _encode_schema(v)}
    if isinstance(v, tuple):
        return {"@tuple": [_enc(x) for x in v]}
    if isinstance(v, (list,)):
        return [_enc(x) for x in v]
    return v


def _dec(v: Any) -> Any:
    if isinstance(v, dict):
        if "@expr" in v:
            return decode_expr(v)
        if "@plan" in v:
            return decode_plan(v)
        if "@agg" in v:
            return AggExpr(v["kind"],
                           decode_expr(v["arg"]) if v["arg"] is not None else None,
                           v["alias"], v["distinct"],
                           arg2=(decode_expr(v["arg2"])
                                 if v.get("arg2") is not None else None),
                           frac=v.get("frac"), wide=v.get("wide", False),
                           carried=v.get("carried", False),
                           shown=v.get("shown"))
        if "@winspec" in v:
            from ..exec.window import WindowFnSpec
            return WindowFnSpec(
                v["kind"],
                decode_expr(v["arg"]) if v["arg"] is not None else None,
                tuple(_dec(e) for e in v["partition_by"]),
                tuple((_dec(e), asc, nf) for e, asc, nf in v["order_by"]),
                v["offset"],
                frame=tuple(v["frame"]) if v.get("frame") is not None else None,
                alias=v["alias"])
        if "@dtype" in v:
            return _decode_dtype(v["@dtype"])
        if "@decimal" in v:
            return decimal.Decimal(v["@decimal"])
        if "@schema" in v:
            return _decode_schema(v["@schema"])
        if "@tuple" in v:
            return tuple(_dec(x) for x in v["@tuple"])
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


def encode_expr(e: E.Expr) -> dict:
    out = {"@expr": type(e).__name__}
    for f in dataclasses.fields(e):
        out[f.name] = _enc(getattr(e, f.name))
    return out


def decode_expr(d: dict) -> E.Expr:
    cls = _EXPR_TYPES[d["@expr"]]
    kwargs = {k: _dec(v) for k, v in d.items() if k != "@expr"}
    return cls(**kwargs)


def encode_plan(p: L.LogicalPlan) -> dict:
    out = {"@plan": type(p).__name__}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if f.name == "table_schema":
            out[f.name] = {"@schema": _encode_schema(v)}
        else:
            out[f.name] = _enc(v)
    return out


def decode_plan(d: dict) -> L.LogicalPlan:
    cls = _PLAN_TYPES[d["@plan"]]
    kwargs = {k: _dec(v) for k, v in d.items() if k != "@plan"}
    return cls(**kwargs)


# Wire-format version (the reference guards cross-version decode with the
# executor's ExecutorSpecification.version + rustc-version plugin checks;
# recover_jobs + the sqlite job store imply cross-process/cross-restart
# decode here). Bump on any breaking change to the encoded plan/graph
# shape; decoders reject mismatches with an actionable error instead of
# failing deep inside field decoding.
WIRE_VERSION = 1


class WireVersionError(ValueError):
    pass


def check_wire_version(doc: dict, what: str = "document"):
    """Raise if `doc` was encoded under a different WIRE_VERSION.
    Documents without a tag predate versioning and are rejected too."""
    v = doc.get("@wire")
    if v != WIRE_VERSION:
        raise WireVersionError(
            f"{what} encoded under wire version {v!r}; this build reads "
            f"version {WIRE_VERSION} — re-submit the job (persisted state "
            "from other versions is not decodable)")


def plan_to_json(p: L.LogicalPlan) -> str:
    doc = encode_plan(p)
    doc["@wire"] = WIRE_VERSION
    return json.dumps(doc)


def plan_from_json(s: str) -> L.LogicalPlan:
    doc = json.loads(s)
    if "@wire" in doc:
        check_wire_version(doc, "plan")
        doc = {k: v for k, v in doc.items() if k != "@wire"}
    return decode_plan(doc)
