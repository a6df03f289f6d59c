"""Quickstart — the codelet API of the port's task runtime in five minutes.

A task is *declared once* with its access modes (paper §4.1) and can carry
several implementations (SpCpu/SpCuda, §4.3); the runtime picks per call.
One ``SpRuntime`` runs the same declarations threaded-eager or
staged (in one policy-chosen order on the calling thread) by flipping
``backend=``.  The data are torch tensors on the card, or on the CPU with
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--out-dir DIR]

``main(argv)`` returns what the output shows.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.core import (
    SpData,
    SpRead,
    SpRuntime,
    SpSpeculativeModel,
    SpWorkerTeam,
    SpWrite,
    sp_task,
)
from repro_torch.kernels.dispatch import resolve_device


# --- declare tasks once: named slots + access modes -------------------------

@sp_task(read=("a",), write=("b",))
def axpy(a, b, *, alpha=2.0):
    """b += alpha * a; `alpha` is a static parameter bound per call."""
    b.value = b.value + alpha * a


@sp_task(commutative=("acc",))
def accumulate(acc, *, inc):
    acc.value = acc.value + inc


@sp_task(read=("cells",))
def total(cells):
    """`cells` is an ARRAY slot: bind a list of SpData (paper Code 3)."""
    return sum(cells)


# annotation spelling: parameter types name the access mode
@sp_task
def scale100(state: SpRead, out: SpWrite):
    time.sleep(0.02)
    out.value = state * 100


@sp_task(maybe=("state",))
def maybe_update(state):  # uncertain writer — does NOT write this time
    time.sleep(0.02)


def make_double(dev: torch.device):
    """A codelet with a host implementation and, on the card, a ``cuda``
    one: the runtime runs the ``cuda`` variant on a ``cuda`` worker."""

    @sp_task(read=("x",), write=("y",))
    def double(x, y):
        y.value = (2.0 * x.cpu(), "ref")

    @double.impl("cuda", available=lambda: dev.type == "cuda")
    def _double_cuda(x, y):
        y.value = (2.0 * x.to(dev), "cuda")

    return double


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=None, help="where the graph and trace go (default: a new temporary directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out_dir = Path(args.out_dir or tempfile.mkdtemp(prefix="quickstart-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    shown: dict = {"device": str(dev)}

    # --- eager backend: a worker-thread engine drives the graph ------------
    with SpRuntime(backend="eager", workers=4) as rt:
        a = SpData(torch.arange(4.0, device=dev), "a")
        b = SpData(torch.zeros(4, device=dev), "b")
        view = axpy(a, b, alpha=2.0)
        view.set_task_name("axpy")
        shown["b"] = view.then(lambda _: b.value.tolist()).result()  # future chaining
        print("b =", shown["b"])

        acc = SpData(torch.zeros((), device=dev), "acc")
        for i in range(8):
            accumulate(acc, inc=i, name=f"accum{i}")
        rt.wait_all_tasks()
        shown["acc"] = float(acc.value)
        print("acc =", shown["acc"], "(order-free accumulation of 0..7)")

        cells = [SpData(torch.tensor(float(i), device=dev), f"c{i}") for i in range(6)]
        shown["sum_cells"] = float(total([cells[i] for i in (1, 3, 5)]).result())
        print("sum of cells [1,3,5] =", shown["sum_cells"])

        graph = rt.graph  # exports (paper Code 8)
        dot, trace = out_dir / "quickstart_graph.dot", out_dir / "quickstart_trace.svg"
        graph.generate_dot(str(dot))
        graph.generate_trace(str(trace))
        shown["exported"] = [str(dot), str(trace)]
        print(f"exported {dot} and {trace}")

    # --- capability dispatch: the cuda variant runs on a cuda worker --------
    double = make_double(dev)
    kind = "cuda" if dev.type == "cuda" else "ref"
    with SpRuntime(backend="eager", workers=SpWorkerTeam([kind])):
        x, y = SpData(torch.tensor(21.0, device=dev), "x"), SpData(None, "y")
        value, ran = double(x, y).then(lambda _: y.value).result()
        shown["double"], shown["double_ran"] = float(value), ran
        shown["double_kinds"] = (double.impl_kinds, double.available_kinds())
        print("double =", shown["double"], "| ran:", ran, "| impls:", double.impl_kinds,
              "available:", double.available_kinds())

    # --- same codelet, staged backend: one linearized program ---------------
    with SpRuntime(backend="staged", policy="fifo"):
        a2 = SpData(torch.arange(4.0, device=dev), "a")
        b2 = SpData(torch.zeros(4, device=dev), "b")
        v2 = axpy(a2, b2, alpha=2.0)
        shown["staged_b"] = v2.then(lambda _: b2.value.tolist()).result()
        print("staged b =", shown["staged_b"], "(identical to eager)")

    # --- speculation: run past an uncertain writer (decorator path) --------
    with SpRuntime(
        backend="eager", workers=4, speculative_model=SpSpeculativeModel.SP_MODEL_1
    ) as rtspec:
        state, out = SpData(torch.ones((), device=dev), "state"), SpData(torch.zeros((), device=dev), "out")
        t0 = time.perf_counter()
        maybe_update(state, name="update")
        scale100(state, out, name="eval")
        rtspec.wait_all_tasks()
        shown["spec_out"] = float(out.value)
        shown["spec_ms"] = (time.perf_counter() - t0) * 1e3
        shown["spec_stats"] = dict(rtspec.graph.spec_stats)
        print(f"speculative eval: out={shown['spec_out']} in {shown['spec_ms']:.0f}ms "
              f"(~20ms thanks to overlap), stats={shown['spec_stats']}")

    # --- compatibility form: the positional paper spelling still works -----
    with SpRuntime(backend="eager", workers=2) as rtc:
        c, d = SpData(torch.tensor(3.0, device=dev), "c"), SpData(None, "d")
        rtc.task(SpRead(c), SpWrite(d), lambda cv, dref: setattr(dref, "value", cv + 1))
        rtc.wait_all_tasks()
        shown["compat_d"] = float(d.value)
        print("compat tg.task spelling: d =", shown["compat_d"])
    return shown


if __name__ == "__main__":
    main()
