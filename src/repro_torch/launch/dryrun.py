"""Dry run: a model of each (arch × shape × mesh) cell's memory, FLOPs and
collectives a device, made on the ``meta`` device without a process group —
the port of ``repro.launch.dryrun``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch X --shape Y --set n_layers=4

Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
in ``repro``'s layout (``memory``, ``cost``, ``collectives``).

Where ``repro`` lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's analyses, :func:`model_cell` *runs* the port's own
step on ``meta`` tensors, as rank 0 of a :class:`~repro_torch.dist.sharding.DryRunMesh`:

* a train cell builds ``Transformer(cfg, device="meta")`` and
  ``build_train_step`` under that mesh (each rank's part of every
  parameter) and runs one whole step — the microbatches, ``grad_finalize``
  and the optimizer — on the local train state and the global batch, of
  which the step takes rank 0's rows.  Nothing in the step reads a value
  back, so it runs on ``meta``; the kernel wrappers take their meta routes
  (``kernels/dispatch.py``), and the mesh's groups record their collectives
  (``dist/collectives.py::RecordingGroup``);
* *memory*: a ``TorchDispatchMode`` follows every storage the step
  allocates (a weakref finalizer on each untyped storage gives its end) and
  keeps the peak of the live bytes, and what was live at that peak.
  ``argument_size_in_bytes`` is the local train state, the int32 step and
  this rank's rows of the inputs; the state is updated in place, so
  ``alias_size_in_bytes`` is the state and the step and
  ``output_size_in_bytes`` adds the returned metrics; ``temp_size_in_bytes``
  is the peak above the arguments (the gradient accumulator, which the port
  keeps between steps, included); ``total_per_device_bytes`` is
  ``repro``'s argument + output + temp − alias;
* *FLOPs*: ``flops`` is what one device does: the matrix products
  (``torch.utils.flop_counter``'s formulas) of every layer and every logits
  chunk, and each kernel's own count from its meta route, over the pairs
  its mask keeps.  XLA's ``cost_analysis`` counts a ``lax.scan`` body once,
  and ``repro`` scans its layers, its logits chunks and its attention's key
  blocks, so ``flops_scan_once`` counts as XLA does: the code outside the
  scans, one layer body (forward, remat recompute, backward) and one logits
  chunk a microbatch (``repro``'s microbatch loop is unrolled), and an
  attention's products over one key block of ``cfg.attn_block_kv`` for
  every query (``repro``'s masked blockwise scan; below
  ``cfg.attn_blockwise_min_seq``, its reference attention over every
  pair), an SSD kernel's over every pair of a chunk (``repro``'s jnp
  ``ssd_chunked`` masks after forming them all).  It exists to be held against ``repro``'s records;
* *collectives*: the recorded calls in ``repro``'s layout, in all and split
  into the layer body (layer 0's), the logits chunk (the first) and the
  rest (``by_part``; the first two summed over the microbatches), with
  ``scan_once`` counted as XLA's text counts them.

The parts of a step are told apart as it runs: a layer (a ``Block`` of the
model: its forward, or its ``decode`` in a decode step) and a logits chunk
(the loss's checkpointed chunk function) mark their forward, their remat
recompute and, through the autograd nodes their forward made, their
backward.

Prefill and decode cells run the port's serving steps on ``meta``, as
``repro``'s dry run lowers its own: ``runtime.serve.build_prefill_fn`` on
this rank's rows of the prompts, and ``build_serve_step`` (one greedy
decode step) on its rows of the tokens, its parts of the caches
(``abstract_cache`` under the mesh: ``repro``'s ``cache_shardings``) and
one position (a scalar, as ``repro``'s; ``pos_per_sequence``: a (B,)
vector, as the serving engine feeds).  Their arguments are the local
parameters and inputs (and caches and position); a decode step updates the
caches in place, so they are its alias bytes.  On a ``model`` axis of m > 1
the sequence-sharded decode's all-gathers (q / k / v, then (out, lse)) and
the greedy argmax's are recorded like the sums.  Every block kind and
frontend runs there (the MoE cells with expert parallelism, and on the
batch axes the all-gather of ``top_i`` where a dispatch group spans ranks
and the load-balance means' sums: ``models/moe.py``; MLA's heads over
``model`` where m divides them and its latent cache by rows:
``models/mla.py``; the SSM on its channels, its sharded weights gathered
and their gradients reduce-scattered: ``models/ssm.py``; the RG-LRU on its
width, ``u`` all-gathered for the gates: ``models/rglru.py``).  A hybrid's
scan body is its first (rec, rec, attn) super-block, its remainder layers
lie outside the scan (``flops_scan_once``, ``scan_once``), as ``repro``
scans it.  What the port cannot run raises, and :func:`run_cell` records
it as ``ok: false`` (with the error), as ``repro``'s records a failed
lowering.  Nothing here imports JAX or ``repro``, or sets ``XLA_FLAGS``.

The MoE configs' default dispatch is ``einsum``: ``repro`` builds one-hot
(G, S, E, C) dispatch and combine tensors and contracts them, FLOPs that
XLA counts; the port writes and gathers each choice's slot instead, so
those products are not in its count.  Read a MoE cell's FLOPs against
``repro``'s ``dispatch="scatter"`` lowering (``--set moe.dispatch=scatter``),
whose products are the port's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist.sharding import DryRunMesh, batch_split_axes, split_rows, use_mesh
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.mesh import MULTI_POD, MULTI_POD_AXES, SINGLE_POD, SINGLE_POD_AXES
from repro_torch.models import SHAPES, ArchConfig, ShapeSpec, Transformer, applicable_shapes
from repro_torch.models import layers as layers_mod
from repro_torch.models.transformer import Block, RecBlock, SSMBlock, hybrid_layout

#: the layer classes whose ``decode`` a decode step calls
BLOCK_CLASSES = (Block, RecBlock, SSMBlock)

#: per-arch dry-run overrides: memory-budget knobs for the ≥100B configs (``repro``'s)
DRYRUN_OVERRIDES: dict[str, dict] = {
    "qwen3-moe-235b-a22b": {"opt_state_dtype": "bfloat16"},
    "llama4-scout-17b-a16e": {"opt_state_dtype": "bfloat16"},
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: the production meshes by ``repro``'s record names
MESHES = {
    "pod_16x16": dict(zip(SINGLE_POD_AXES, SINGLE_POD)),
    "multipod_2x16x16": dict(zip(MULTI_POD_AXES, MULTI_POD)),
}

OUTDIR = "experiments/dryrun_torch"

_REGION = "repro_torch.dryrun.region"  # key of an autograd node's metadata


def config_for_dryrun(arch: str, overrides: dict | None = None) -> ArchConfig:
    cfg = get_config(arch)
    kw = dict(DRYRUN_OVERRIDES.get(arch, {}))
    if overrides:
        kw.update(overrides)
    # nested override support: {"moe.dispatch": "scatter"}
    flat = {k: v for k, v in kw.items() if "." not in k}
    nested = {k: v for k, v in kw.items() if "." in k}
    if flat:
        cfg = cfg.replace(**flat)
    for key, val in nested.items():
        head, field = key.split(".", 1)
        sub = getattr(cfg, head)
        cfg = cfg.replace(**{head: dataclasses.replace(sub, **{field: val})})
    return cfg


def collective_stats(records: list[dict]) -> dict:
    """``repro``'s per-device collective layout of a list of
    ``CollectiveLog`` records: per kind ``count``, ``bytes``,
    ``wire_bytes``, and the totals."""
    out = {k: {"count": 0, "bytes": 0, "wire_bytes": 0} for k in _COLLECTIVES}
    for r in records:
        out[r["kind"]]["count"] += 1
        out[r["kind"]]["bytes"] += r["bytes"]
        out[r["kind"]]["wire_bytes"] += r["wire_bytes"]
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in out.values() if isinstance(v, dict))
    out["total_count"] = sum(v["count"] for v in out.values() if isinstance(v, dict))
    return out


# ---------------------------------------------------------------------------
# The step's parts: a layer body, a logits chunk, the rest.
# ---------------------------------------------------------------------------

class _Parts:
    """Which part of the step an op belongs to: ``("layer", i)`` for layer
    i, ``("chunk", j)`` for the j-th logits chunk of a microbatch, None for
    the rest.  Forwards (and remat recomputes) push their part while they
    run; their autograd nodes carry it into the backward."""

    def __init__(self, model: Transformer, n_chunks: int):
        self.stack: list = []
        self.layer_of = {id(m): i for i, m in enumerate(model.layers)}
        self.n_chunks = max(n_chunks, 1)
        self.chunks_seen = 0

    def current(self):
        if self.stack:
            return self.stack[-1]
        node = torch._C._current_autograd_node()
        return None if node is None else node.metadata.get(_REGION)

    @staticmethod
    def tag(outputs, inputs, part) -> None:
        """Mark every autograd node between ``outputs`` and ``inputs`` with
        ``part``."""
        # held while the walk runs: a node's Python object (and so its id) is
        # the same only while one is alive
        ends = [t.grad_fn for t in inputs if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        stop = {id(n) for n in ends}
        todo = [t.grad_fn for t in outputs if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or id(node) in stop or node.metadata.get(_REGION) == part:
                continue
            node.metadata[_REGION] = part
            todo.extend(f for f, _ in node.next_functions)

    # module hooks (the layers)
    def pre_hook(self, module, args):
        if id(module) in self.layer_of:
            self.stack.append(("layer", self.layer_of[id(module)]))

    def post_hook(self, module, args, output):
        """Also called when a remat recompute stops early (by raising):
        ``output`` is None then."""
        if id(module) in self.layer_of:
            part = self.stack.pop()
            if output is not None:
                self.tag(tree_flatten(output)[0], tree_flatten(args)[0], part)

    def decode_method(self, fn):
        """A block class's ``decode``, marking its layer's part: a decode
        step calls it, not the module, so no forward hook sees the layer."""

        def decode(module, *args, **kw):
            i = self.layer_of.get(id(module))
            if i is not None:
                self.stack.append(("layer", i))
            try:
                return fn(module, *args, **kw)
            finally:
                if i is not None:
                    self.stack.pop()

        return decode

    def chunk_fn(self, fn):
        """The loss's chunk function, marking its part: a new chunk index in
        the forward, its node's part in a recompute (in the backward)."""

        def chunk(xc, lc, mc, model, cfg):
            node = torch._C._current_autograd_node()
            part = None if node is None else node.metadata.get(_REGION)
            if part is None:
                part = ("chunk", self.chunks_seen % self.n_chunks)
                self.chunks_seen += 1
            self.stack.append(part)
            try:
                out = fn(xc, lc, mc, model, cfg)
            finally:
                self.stack.pop()
            self.tag([out], [xc], part)
            return out

        return chunk


class _Tracker(TorchDispatchMode):
    """Live bytes of every storage the run allocates (``known``: storages
    that exist already and are not counted), their peak and what was live
    at it (bytes by the part of the step and the op that made them), and
    the FLOPs of every op and of the kernels' meta routes, by part of the
    step."""

    def __init__(self, parts: _Parts, known: list[torch.Tensor]):
        super().__init__()
        self.parts = parts
        self.seen: dict[int, tuple] = {}
        for t in known:
            self._note(t.untyped_storage(), counted=False, label=None)
        self.live = 0
        self.peak = 0
        self.at_peak: dict = {}
        self._rising = False
        self.flops: dict = defaultdict(int)
        self.kernels: list = []

    def _note(self, st, *, counted: bool, label) -> None:
        sid = id(st)
        if sid in self.seen:
            return
        n = st.nbytes() if counted else 0
        self.seen[sid] = (n, label)
        weakref.finalize(st, self._free, sid)
        if n:
            self.live += n
            if self.live > self.peak:
                self.peak, self._rising = self.live, True

    def _free(self, sid: int) -> None:
        n, _ = self.seen[sid]
        if n:
            self.finish()  # the first free after a rise: the live set is at a (local) peak
        self.live -= n
        del self.seen[sid]

    def kernel_call(self, name, shape, flops, info) -> None:
        part = self.parts.current()
        self.flops[part] += flops
        self.kernels.append(dict(name=name, shape=shape, flops=flops, part=part, **info))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        part = self.parts.current()
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops[part] += flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            self.flops[part] += _elementwise_flops(func, args, out)
        label = ("outside" if part is None else part[0], packet.__name__)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                self._note(t.untyped_storage(), counted=True, label=label)
        return out

    def finish(self) -> None:
        """Keep what is live if this is the highest peak yet."""
        if self._rising and self.live == self.peak:
            held: dict = defaultdict(int)
            for m, label in self.seen.values():
                if m:
                    held[label] += m
            self.at_peak = dict(held)
        self._rising = False


#: elementwise ops XLA's cost analysis counts as transcendentals, not flops
_TRANSCENDENTAL = frozenset({"exp", "exp2", "expm1", "log", "log1p", "log2", "sigmoid", "pow", "rsqrt", "sqrt",
                             "tanh", "sin", "cos", "tan", "atan2", "erf"})
#: reductions: (elements in) − (elements out) operations, as XLA counts a reduce
_REDUCTIONS = frozenset({"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod", "cumsum", "any", "all",
                         "norm", "linalg_vector_norm"})


def _elementwise_flops(func, args, out) -> int:
    """XLA's count of an op that is not a matrix product: one operation an
    output element of an elementwise op (none for a transcendental), the
    elements reduced away by a reduction, nothing for a copy, view or
    gather."""
    name = func.overloadpacket.__name__.rstrip("_")
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    if not outs:
        return 0
    if name in _REDUCTIONS:
        inp = args[0] if args and isinstance(args[0], torch.Tensor) else None
        return max(0, (inp.numel() if inp is not None else 0) - outs[0].numel())
    if torch.Tag.pointwise in func.tags and name not in _TRANSCENDENTAL:
        return outs[0].numel()
    return 0


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _attention_scan_once_flops(call: dict, cfg: ArchConfig) -> int:
    """A flash call's operations as XLA counts ``repro``'s attention: over
    one key block of ``attn_block_kv`` for every query (its masked
    blockwise scan, counted once), or every pair below
    ``attn_blockwise_min_seq`` (its reference attention)."""
    B, Lq, Lk, H, _, Dh, Dv = call["shape"]
    keys = Lk if Lq < cfg.attn_blockwise_min_seq else min(cfg.attn_block_kv, Lk)
    count = flash_ops.fwd_flops if call["name"] == "flash_attention" else flash_ops.bwd_flops
    return count(B, H, Dh, Dv, Lq * keys)


def _ssd_scan_once_flops(call: dict) -> int:
    """An SSD kernel call's operations as XLA counts ``repro``'s jnp
    ``ssd_chunked``: its intra-chunk products over every (i, j) pair of a
    chunk (it masks the upper triangle after forming it), where the kernels
    count the causal pairs."""
    b, H, nc, cs, P, _, N = call["shape"]
    if call["name"] == "ssd_intra_chunk":
        return b * H * nc * (2 * cs * cs * (N + P) + 2 * cs * N * P)
    return b * H * nc * (2 * cs * cs * (3 * N + 2 * P) + 4 * cs * N * P)


def _run_instrumented(model: Transformer, n_chunks: int, known: list, log, fn):
    """Run ``fn()`` under the tracker, the part hooks and the kernels' meta
    routes, ``log`` (a ``CollectiveLog`` or None) naming each collective's
    part; → (fn's result, the tracker)."""
    parts = _Parts(model, n_chunks)
    tracker = _Tracker(parts, known)
    if log is not None:
        log.region = parts.current
    hooks = (torch.nn.modules.module.register_module_forward_pre_hook(parts.pre_hook),
             torch.nn.modules.module.register_module_forward_hook(parts.post_hook, always_call=True))
    chunk_nll, decodes = layers_mod._chunk_nll, {cls: cls.decode for cls in BLOCK_CLASSES}
    layers_mod._chunk_nll = parts.chunk_fn(chunk_nll)
    for cls, decode in decodes.items():
        cls.decode = parts.decode_method(decode)
    try:
        with dispatch.meta_kernel_calls(tracker.kernel_call), tracker:
            result = fn()
        tracker.finish()
    finally:
        layers_mod._chunk_nll = chunk_nll
        for cls, decode in decodes.items():
            cls.decode = decode
        for h in hooks:
            h.remove()
    return result, tracker


def _scan_body_layers(cfg: ArchConfig) -> frozenset:
    """The layers of what XLA counts of ``repro``'s layer scan: layer 0 of
    a stack of one kind; a hybrid's first super-block and its remainder
    layers (outside the scan)."""
    if cfg.family != "hybrid":
        return frozenset({0})
    n_super, rem = hybrid_layout(cfg)
    k = len(cfg.hybrid.pattern)
    return frozenset(range(min(k, n_super * k))) | frozenset(range(n_super * k, n_super * k + len(rem)))


def _first_of_scan(part, body: frozenset = frozenset({0})) -> bool:
    """Part of what XLA counts of a scan: outside every scan, or its first
    body (the layers ``body``, a microbatch's first logits chunk)."""
    return part is None or part[1] in (body if part[0] == "layer" else (0,))


def model_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Optional[DryRunMesh], n_microbatches: int = 1,
               pos_per_sequence: bool = False) -> dict:
    """Model one cell on ``meta`` as rank 0 of ``mesh`` (None: one device,
    no mesh): → ``{"memory", "cost", "collectives", "peak_terms",
    "kernels"}`` (module docstring).  A decode cell's position is a scalar
    unless ``pos_per_sequence``.  Raises what the port raises for a cell
    it cannot run (a kernel's ``ValueError`` for a shape it refuses)."""
    from repro_torch.models import abstract_cache, abstract_inputs, set_trainable
    from repro_torch.optim import TrainState
    from repro_torch.runtime.serve import build_prefill_fn, build_serve_step
    from repro_torch.runtime.train import _model_optimizer, build_train_step, state_bytes

    log = mesh.log if mesh is not None else None
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        model = Transformer(cfg, device="meta")
        inputs = abstract_inputs(cfg, shape)
        if shape.kind == "train":
            set_trainable(model)
            opt = _model_optimizer(cfg, model)[0](dict(model.named_parameters()))
            state = TrainState(step=torch.zeros((), dtype=torch.int32, device="meta"), params=model, opt=opt)
            art = build_train_step(cfg, n_microbatches=n_microbatches)
            rows = _local_rows(inputs, mesh)
            n_chunks = (shape.seq_len // cfg.logits_chunk) if cfg.logits_chunk else 1
            known = list(model.parameters()) + _leaves(opt) + [state.step] + list(inputs.values())
            (state, metrics), tr = _run_instrumented(model, n_chunks, known, log, lambda: art(state, inputs))
            sb = state_bytes(state)
            state_total = sb["params"] + sb["opt"] + 4
            arguments = state_total + _nbytes(rows.values())
            outputs = state_total + _nbytes(metrics.values())
            alias = state_total
        elif shape.kind == "prefill":
            rows = _local_rows(inputs, mesh)
            known = list(model.parameters()) + list(inputs.values())
            with split_rows(() if mesh is None else batch_split_axes(shape.global_batch, mesh)):
                _, tr = _run_instrumented(model, 1, known, log, lambda: build_prefill_fn(cfg)(model, rows))
            arguments = _nbytes(model.parameters()) + _nbytes(rows.values())
            outputs, alias = 0, 0
        else:  # decode: one greedy step against caches of the shape's length
            rows = _local_rows(inputs, mesh)
            caches = abstract_cache(cfg, shape.global_batch, shape.seq_len)  # this rank's parts
            B = rows["tokens"].shape[0]
            pos = torch.zeros((B,) if pos_per_sequence else (), dtype=torch.int32, device="meta")
            cache_leaves = _leaves(caches)
            known = list(model.parameters()) + list(inputs.values()) + cache_leaves + [pos]
            step = build_serve_step(cfg, shape)
            _, tr = _run_instrumented(model, 1, known, log, lambda: step(model, rows["tokens"], caches, pos))
            arguments = _nbytes(model.parameters()) + _nbytes(rows.values()) + _nbytes(cache_leaves) + _nbytes([pos])
            outputs, alias = 0, _nbytes(cache_leaves)
    temp = tr.peak
    memory = {
        "argument_size_in_bytes": arguments,
        "output_size_in_bytes": outputs,
        "temp_size_in_bytes": temp,
        "alias_size_in_bytes": alias,
        "total_per_device_bytes": arguments + outputs + temp - alias,
        "peak_bytes": arguments + temp,
    }
    flops = sum(tr.flops.values())
    body = _scan_body_layers(cfg)
    scan_once = sum(f for part, f in tr.flops.items() if _first_of_scan(part, body))
    # the attention's kernels as XLA counts repro's blockwise scan
    for call in tr.kernels:
        if call["name"] in ("flash_attention", "flash_attention_bwd") and _first_of_scan(call["part"], body):
            scan_once += _attention_scan_once_flops(call, cfg) - call["flops"]
        elif call["name"] in ("ssd_intra_chunk", "ssd_intra_chunk_bwd") and _first_of_scan(call["part"], body):
            scan_once += _ssd_scan_once_flops(call) - call["flops"]
    by_part: dict = defaultdict(int)
    for part, f in tr.flops.items():
        by_part["outside" if part is None else f"{part[0]}_body"] += f
    kernels: dict = {}
    for call in tr.kernels:
        k = kernels.setdefault(call["name"], {"calls": 0, "flops": 0})
        k["calls"] += 1
        k["flops"] += call["flops"]
    cost = {"flops": float(flops), "flops_scan_once": float(scan_once),
            "flops_by_part": {k: float(v) for k, v in by_part.items()}}
    records = log.records if log is not None else []
    collectives = collective_stats(records)
    collectives["scan_once"] = collective_stats([r for r in records if _first_of_scan(r["region"], body)])
    collectives["by_part"] = {
        name: collective_stats([r for r in records if keep(r["region"])])
        for name, keep in (("layer_body", lambda p: p == ("layer", 0)),
                           ("logits_chunk", lambda p: p == ("chunk", 0)),
                           ("outside", lambda p: p is None))
    }
    peak_terms = sorted(([f"{where}:{op}", b] for (where, op), b in tr.at_peak.items()),
                        key=lambda t: -t[1])
    return {"memory": memory, "cost": cost, "collectives": collectives,
            "peak_terms": peak_terms[:16], "kernels": kernels}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _local_rows(inputs: dict, mesh) -> dict:
    """Rank 0's rows of the global batch, as the train step takes them."""
    if mesh is None:
        return inputs
    from repro_torch.dist.sharding import mesh_shape, safe_spec, spec_axes

    B = next(iter(inputs.values())).shape[0]
    n = math.prod(mesh_shape(mesh)[a] for a in spec_axes(safe_spec((B,), ("batch",), mesh=mesh)[0]))
    return {k: t[: B // n] for k, t in inputs.items()}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    overrides: dict | None = None,
    tag: str = "",
    outdir: str = OUTDIR,
) -> dict:
    overrides = dict(overrides or {})
    n_microbatches = int(overrides.pop("n_microbatches", 1))
    cfg = config_for_dryrun(arch, overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    mesh = DryRunMesh(MESHES[mesh_name])
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": mesh.size,
        "tag": tag,
        "overrides": dict(overrides or {}, n_microbatches=n_microbatches),
    }
    t0 = time.time()
    try:
        rec.update(model_cell(cfg, shape, mesh, n_microbatches=n_microbatches))
        rec["model_s"] = round(time.time() - t0, 1)
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    os.makedirs(outdir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "") + ".json"
    with open(os.path.join(outdir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _parse_set(items: list[str]) -> dict:
    overrides: dict = {}
    for kv in items:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
        overrides[k] = v
    return overrides


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. moe.dispatch=scatter, n_microbatches=2)")
    args = ap.parse_args(argv)
    overrides = _parse_set(args.set)
    meshes = [False] if args.single_pod else [True] if args.multi_pod else [False, True]
    if args.all:
        cells = [(arch, s.name) for arch in ARCH_NAMES for s in applicable_shapes(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    out = []
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, overrides or None, args.tag, args.outdir)
            status = "OK " if rec["ok"] else "FAIL"
            print(
                f"[{status}] {arch:26s} {shape:12s} {rec['mesh']:16s} model={rec.get('model_s', '-'):>6}s "
                + (
                    f"flops/dev={rec['cost']['flops']:.3e} scan-once={rec['cost']['flops_scan_once']:.3e} "
                    f"coll={rec['collectives']['total_bytes']:.3e}B"
                    if rec["ok"]
                    else rec.get("error", "")
                ),
                flush=True,
            )
            if rec["ok"]:
                print(json.dumps(rec["memory"], indent=None), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
