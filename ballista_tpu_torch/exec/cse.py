"""Common-subplan elimination over physical operator trees (port of
ballista_tpu/exec/cse.py).

Subquery decorrelation (EXISTS/IN -> semi/anti joins) replans the outer
join chain once per subquery: TPC-H Q21 carries three structurally
identical copies of its nation-supplier-lineitem-orders chain. This pass
merges structurally identical subtrees into one shared node object and
counts each node's parent edges; `Run.eval` (exec/plan.py) then evaluates
a shared node once per run and hands the same output to every parent.

Two subtrees merge only when every constructor argument of every node in
them agrees. Expressions enter the key by their dataclass `repr`, which is
structural down to literal types (`str(expr)` is a display name: it drops
casts and prints every CASE as "case"). Dictionaries and lookup tables
enter by object identity: equal contents in different objects are left
unmerged, which costs time, never a wrong answer.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .plan import ExecNode

# every attribute a node's constructor argument lands in, beyond children,
# schema and capacity: (attribute, how it enters the key)
_EXPR_ATTRS = (
    "predicate",                  # FilterExec, NestedLoopJoinExec
    "exprs",                      # ProjectExec
    "group_exprs", "aggs", "pre_filter",          # HashAggregateExec
    "build_pre_filter", "probe_pre_filter",       # HashJoinExec
    "keys",                       # SortExec
    "specs",                      # WindowExec
)
_VALUE_ATTRS = (
    "emit_sparse",                # FilterExec, HashJoinExec
    "input_id",                   # InputLeaf
    "device",                     # OneRowExec
    "mode", "table_size", "_group_names",         # HashAggregateExec
    "on", "join_type", "unique_build", "out_capacity",   # HashJoinExec
    "chunk_b",                    # NestedLoopJoinExec (from opts)
    "n", "offset",                # LimitExec
    "key_names", "n_parts", "quota",                 # ExchangeExec, GatherExec
    "salt", "salt_mode", "salt_kind", "value_hash",  # ExchangeExec
)


def _node_key(node: ExecNode, child_keys: Tuple) -> Tuple:
    extras = []
    for a in _EXPR_ATTRS:
        if hasattr(node, a):
            extras.append((a, repr(getattr(node, a))))
    for a in _VALUE_ATTRS:
        if hasattr(node, a):
            extras.append((a, str(getattr(node, a))))
    # host lookup tables (DictRemapExec): by identity
    if hasattr(node, "_luts"):
        extras.append(("_luts", tuple(sorted(
            (i, id(l)) for i, l in node._luts.items()))))
    schema = node.schema
    schema_key = (tuple((f.name, repr(f.dtype), f.nullable)
                        for f in schema.fields),
                  tuple(sorted((k, id(v))
                               for k, v in schema.dictionaries.items())),
                  tuple(sorted(schema.int_bounds.items())))
    return (type(node).__name__, node.capacity, schema_key, tuple(extras),
            child_keys)


def cse_tree(root: ExecNode) -> ExecNode:
    """Merge structurally identical subtrees (bottom-up) and set every
    node's `n_parents` to its number of parent edges. Idempotent."""
    pool: Dict[Tuple, ExecNode] = {}

    def rebuild(node: ExecNode) -> Tuple[ExecNode, Tuple]:
        child_results = [rebuild(c) for c in node.children]
        if child_results:
            node.children = tuple(n for n, _ in child_results)
        key = _node_key(node, tuple(k for _, k in child_results))
        return pool.setdefault(key, node), key

    new_root, _ = rebuild(root)
    for node in pool.values():
        node.n_parents = 0
    new_root.n_parents = 1
    for node in pool.values():
        for c in node.children:
            c.n_parents += 1
    return new_root
