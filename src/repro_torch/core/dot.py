"""DOT export of the task graph (paper §4.8, Code 8)."""
from __future__ import annotations


_COLORS = {
    "comm": "lightskyblue",
    "spec": "khaki",
    "normal": "white",
}


def _escape(s: str) -> str:
    return s.replace('"', r"\"")


def graph_to_dot(graph, *, show_accesses: bool = False) -> str:
    lines = ["digraph taskgraph {", "  rankdir=TB;", "  node [shape=box, style=filled];"]
    for t in graph.tasks:
        color = "comm" if t.is_comm else ("spec" if t.speculative else "normal")
        label = _escape(t.name)
        if show_accesses:
            accs = ", ".join(f"{a.mode.value}:{a.data.name}" for a in t.accesses)
            label += rf"\n[{_escape(accs)}]"
        lines.append(f'  t{t.uid} [label="{label}", fillcolor={_COLORS[color]}];')
    seen: set[tuple[int, int]] = set()
    for src, dst in graph.edges():
        k = (src.uid, dst.uid)
        if k not in seen:
            seen.add(k)
            lines.append(f"  t{src.uid} -> t{dst.uid};")
    lines.append("}")
    return "\n".join(lines) + "\n"
