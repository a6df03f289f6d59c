"""Execution-trace SVG export (paper §4.8).

One horizontal lane per worker; each executed task is a rectangle scaled to
its duration, hoverable (``<title>``) for name/duration; a polyline under
the lanes shows the number of ready tasks over time — the paper's
"number of tasks available during the execution" track.
"""
from __future__ import annotations

import colorsys


def _color(uid: int) -> str:
    h = (uid * 0.6180339887) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.45, 0.92)
    return f"#{int(r * 255):02x}{int(g * 255):02x}{int(b * 255):02x}"


def trace_to_svg(graph, show_dependencies: bool = True, width: int = 1200) -> str:
    events = sorted(graph.trace_events, key=lambda e: e["t0"])
    if not events:
        return (
            '<svg xmlns="http://www.w3.org/2000/svg" width="400" height="40">'
            "<text x='10' y='25'>empty trace</text></svg>"
        )
    t0 = min(e["t0"] for e in events)
    t1 = max(e["t1"] for e in events)
    span = max(t1 - t0, 1e-9)
    workers = sorted({e["worker"] for e in events})
    lane_h, pad, label_w = 26, 6, 110
    plot_w = width - label_w - 2 * pad
    ready_h = 60
    height = pad * 3 + lane_h * len(workers) + ready_h + 30

    def x(t: float) -> float:
        return label_w + pad + (t - t0) / span * plot_w

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
        'font-family="monospace" font-size="11">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
    ]
    lane_y = {w: pad + i * lane_h for i, w in enumerate(workers)}
    for w, y in lane_y.items():
        out.append(f'<text x="4" y="{y + lane_h * 0.7:.1f}">{w}</text>')
        out.append(
            f'<line x1="{label_w}" y1="{y + lane_h:.1f}" x2="{width - pad}" '
            f'y2="{y + lane_h:.1f}" stroke="#ddd"/>'
        )
    for e in events:
        y = lane_y[e["worker"]]
        xa, xb = x(e["t0"]), x(e["t1"])
        wdt = max(xb - xa, 0.75)
        fill = "#9ecae1" if e.get("comm") else ("#fee391" if e.get("spec") else _color(e["uid"]))
        dur_us = (e["t1"] - e["t0"]) * 1e6
        out.append(
            f'<rect x="{xa:.2f}" y="{y + 2}" width="{wdt:.2f}" height="{lane_h - 4}" '
            f'fill="{fill}" stroke="#555" stroke-width="0.4">'
            f"<title>{e['task']} ({dur_us:.1f} us)</title></rect>"
        )
    # ready-tasks-over-time track
    ry = pad * 2 + lane_h * len(workers)
    max_ready = max(1, max(e.get("ready", 0) for e in events))
    out.append(f'<text x="4" y="{ry + 12}">ready</text>')
    pts = []
    for e in events:
        yy = ry + ready_h - e.get("ready", 0) / max_ready * (ready_h - 10)
        pts.append(f"{x(e['t0']):.1f},{yy:.1f}")
    if len(pts) >= 2:
        out.append(
            f'<polyline points="{" ".join(pts)}" fill="none" stroke="#e6550d" stroke-width="1.2"/>'
        )
    out.append(
        f'<text x="{label_w}" y="{height - 8}">span={span * 1e3:.3f} ms, '
        f"tasks={len(events)}, max_ready={max_ready}</text>"
    )
    out.append("</svg>")
    return "\n".join(out)


def trace_metrics(graph) -> dict:
    """Concise execution-quality metrics — the paper's §4.8 "next release"
    feature ("export metrics that will provide concise but meaningful
    numbers on execution quality, such as the idle time")."""
    events = sorted(graph.trace_events, key=lambda e: e["t0"])
    if not events:
        return {"n_tasks": 0}
    t0 = min(e["t0"] for e in events)
    t1 = max(e["t1"] for e in events)
    span = max(t1 - t0, 1e-12)
    workers = sorted({e["worker"] for e in events})
    busy = {w: 0.0 for w in workers}
    for e in events:
        busy[e["worker"]] += e["t1"] - e["t0"]
    idle = {w: span - b for w, b in busy.items()}
    total_busy = sum(busy.values())
    durations = [e["t1"] - e["t0"] for e in events]
    return {
        "n_tasks": len(events),
        "n_workers": len(workers),
        "span_s": span,
        "busy_s": total_busy,
        "utilization": total_busy / (span * len(workers)),
        "idle_per_worker_s": idle,
        "mean_task_us": 1e6 * sum(durations) / len(durations),
        "max_task_us": 1e6 * max(durations),
        "comm_tasks": sum(1 for e in events if e.get("comm")),
        "speculative_tasks": sum(1 for e in events if e.get("spec")),
    }
