"""Function registry — list/search the engine's SQL functions (port of
ballista_tpu/functions.py).

Reference parity: `ballista-cli`'s ListFunctions / SearchFunctions commands
(ballista-cli/src/command.rs:36) and the UDF plugin registry
(core/src/plugin/udf.rs). The names are read from the tables the port's
own binder and parser work from (`exprs.SCALAR_FN_NAMES`, the parser's
aggregate and window names, `exprs._UDF_REGISTRY`), so a function that
does not bind is not listed; this module only adds the descriptions.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class FunctionInfo:
    __slots__ = ("name", "kind", "signature", "description")

    def __init__(self, name: str, kind: str, signature: str,
                 description: str):
        self.name = name
        self.kind = kind  # scalar | aggregate | window | udf
        self.signature = signature
        self.description = description

    def as_dict(self) -> Dict[str, str]:
        return {"name": self.name, "kind": self.kind,
                "signature": self.signature,
                "description": self.description}


# name -> (signature, description); a name the tables hold and this map
# does not is listed with a generic signature
_DOCS = {
    "abs": ("abs(x)", "absolute value"),
    "coalesce": ("coalesce(a, b, ...)", "first non-NULL argument"),
    "substring": ("substring(s, start, len)",
                  "substring of a dictionary-encoded string column"),
    "upper": ("upper(s)", "uppercase (dict LUT)"),
    "lower": ("lower(s)", "lowercase (dict LUT)"),
    "trim": ("trim(s)", "strip whitespace"),
    "ltrim": ("ltrim(s)", "strip left whitespace"),
    "rtrim": ("rtrim(s)", "strip right whitespace"),
    "reverse": ("reverse(s)", "reverse string"),
    "replace": ("replace(s, from, to)", "literal substring replacement"),
    "length": ("length(s)", "character length"),
    "char_length": ("char_length(s)", "character length"),
    "character_length": ("character_length(s)", "character length"),
    "octet_length": ("octet_length(s)", "UTF-8 byte length"),
    "concat": ("concat(a, b, ...) / a || b",
               "string concatenation (1-2 dict columns + literals)"),
    "date_trunc": ("date_trunc('year'|'month', d)", "truncate a date"),
    "floor": ("floor(x)", "round down"),
    "ceil": ("ceil(x)", "round up"),
    "ceiling": ("ceiling(x)", "round up"),
    "round": ("round(x)", "round half to even"),
    "sqrt": ("sqrt(x)", "square root"),
    "extract_year": ("extract(year from d)", "year of a date column"),
    "extract_month": ("extract(month from d)", "month of a date column"),
    "extract_day": ("extract(day from d)", "day of a date column"),
    "count": ("count(*) | count(x) | count(distinct x)",
              "row / non-NULL / distinct count"),
    "sum": ("sum([distinct] x)", "sum"),
    "avg": ("avg([distinct] x)", "arithmetic mean"),
    "min": ("min(x)", "minimum"),
    "max": ("max(x)", "maximum"),
    "stddev": ("stddev(x)", "sample standard deviation"),
    "stddev_samp": ("stddev_samp(x)", "sample standard deviation"),
    "stddev_pop": ("stddev_pop(x)", "population standard deviation"),
    "var": ("var(x)", "sample variance"),
    "variance": ("variance(x)", "sample variance"),
    "var_samp": ("var_samp(x)", "sample variance"),
    "var_pop": ("var_pop(x)", "population variance"),
    "median": ("median(x)", "exact median"),
    "corr": ("corr(x, y)", "Pearson correlation coefficient"),
    "percentile_cont": ("percentile_cont(f) within group (order by x)",
                        "continuous percentile"),
    "approx_percentile_cont": ("approx_percentile_cont(x, f)",
                               "continuous percentile (computed exactly)"),
    "grouping": ("grouping(col)",
                 "1 when col is aggregated in a GROUPING SETS superset row"),
    "row_number": ("row_number() over (...)",
                   "1-based row number within the partition"),
    "rank": ("rank() over (...)", "rank with gaps"),
    "dense_rank": ("dense_rank() over (...)", "rank without gaps"),
    "ntile": ("ntile(n) over (...)", "n roughly-equal buckets"),
    "percent_rank": ("percent_rank() over (...)", "(rank-1)/(rows-1)"),
    "cume_dist": ("cume_dist() over (...)", "cumulative distribution"),
    "lag": ("lag(x[, n]) over (...)", "value n rows before"),
    "lead": ("lead(x[, n]) over (...)", "value n rows after"),
    "first_value": ("first_value(x) over (...)", "first value in frame"),
    "last_value": ("last_value(x) over (...)", "last value in frame"),
    "nth_value": ("nth_value(x, k) over (...)", "k-th value in frame"),
}


def _info(name: str, kind: str) -> FunctionInfo:
    signature, description = _DOCS.get(name, (f"{name}(...)", name))
    return FunctionInfo(name, kind, signature, description)


def list_functions(kind: Optional[str] = None) -> List[FunctionInfo]:
    """All functions, built-ins plus runtime-registered UDFs."""
    from . import exprs
    from .sql import parser

    out = [_info(n, "scalar") for n in exprs.SCALAR_FN_NAMES]
    out += [_info(n, "aggregate")
            for n in parser.BASIC_AGG_NAMES + tuple(parser.MOMENT_AGG_NAMES)
            + ("grouping",)]
    out += [_info(n, "window") for n in parser.WINDOW_FNS]
    for name, (fn, out_dtype, _prop) in sorted(exprs._UDF_REGISTRY.items()):
        out.append(FunctionInfo(name, "udf", f"{name}(...) -> {out_dtype!r}",
                                (fn.__doc__ or "user-defined function")
                                .strip().splitlines()[0]))
    if kind is not None:
        out = [f for f in out if f.kind == kind]
    return out


def search_functions(pattern: str) -> List[FunctionInfo]:
    """Case-insensitive substring match over name and description."""
    pat = pattern.lower()
    return [f for f in list_functions()
            if pat in f.name.lower() or pat in f.description.lower()]
