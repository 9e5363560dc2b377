"""Graphviz dot renderings of plans and stage DAGs (port of
ballista_tpu/utils/dot.py, host only).

Reference parity: `ExecutionGraphDot` (`state/execution_graph_dot.rs:48`)
and `produce_diagram` (`core/src/utils.rs:231`) — the REST API serves these
per job (`/api/job/{id}/dot`); same renderings here for introspection.
"""

from __future__ import annotations


def _esc(s: str) -> str:
    return s.replace('"', '\\"')


def logical_plan_dot(plan) -> str:
    lines = ["digraph logical_plan {", "  node [shape=box];"]
    counter = [0]

    def walk(p) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        lines.append(f'  {nid} [label="{_esc(p._label())}"];')
        for c in p.children():
            cid = walk(c)
            lines.append(f"  {cid} -> {nid};")
        return nid

    walk(plan)
    lines.append("}")
    return "\n".join(lines)


def stage_dot(dplan, stage_id: int) -> str:
    """Single-stage operator tree (`/api/job/{id}/stage/{n}/dot` parity,
    api/handlers.rs:292)."""
    stage = next((s for s in dplan.stages if s.stage_id == stage_id), None)
    if stage is None:
        raise KeyError(stage_id)
    lines = [f"digraph stage_{stage_id} {{", "  node [shape=box];"]
    counter = [0]

    def walk(node) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        lines.append(f'  {nid} [label="{_esc(node._label())}"];')
        for c in node.children:
            cid = walk(c)
            lines.append(f"  {cid} -> {nid};")
        return nid

    walk(stage.root)
    lines.append("}")
    return "\n".join(lines)


def distributed_plan_dot(dplan) -> str:
    """Stage DAG with per-stage operator trees in clusters (the
    ExecutionGraphDot layout: one cluster per stage, edges at shuffle
    boundaries)."""
    lines = ["digraph distributed_plan {", "  node [shape=box];"]
    counter = [0]
    stage_root_node = {}

    for stage in dplan.stages:
        lines.append(f"  subgraph cluster_{stage.stage_id} {{")
        lines.append(f'    label="Stage {stage.stage_id}";')
        leaf_nodes = {}

        def walk(node) -> str:
            nid = f"s{stage.stage_id}_n{counter[0]}"
            counter[0] += 1
            lines.append(f'    {nid} [label="{_esc(node._label())}"];')
            from ..exec.plan import InputLeaf
            if isinstance(node, InputLeaf):
                leaf_nodes[nid] = node.input_id
            for c in node.children:
                cid = walk(c)
                lines.append(f"    {cid} -> {nid};")
            return nid

        root_id = walk(stage.root)
        stage_root_node[stage.stage_id] = root_id
        lines.append("  }")
        # cross-stage edges
        for nid, input_id in leaf_nodes.items():
            src = stage.sources[input_id]
            if src.kind == "stage":
                lines.append(
                    f"  {stage_root_node[int(src.name)]} -> {nid} "
                    '[style=dashed, label="shuffle"];')
    lines.append("}")
    return "\n".join(lines)
