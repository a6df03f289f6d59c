"""Is the ssd gradient on the card the same on every run?

``tests/test_torch_cuda_kernels.py::test_ssd_chunked_gradients_on_the_card``
(fp32, a SIMT route) once missed its tolerance in 10 of 307,200
x-gradient elements.  Its inputs are seeded and the ssd kernels are meant
to be run-to-run identical, so this repeats its computation and compares
every stage bit for bit with the first iteration's:

- ``fwd``: the outputs of the intra-chunk forward kernel (fp32 takes the
  wide route, ``csrc/ssd_wide.cu``);
- ``bwd_in``: the cotangents autograd hands the backward kernel;
- ``bwd``: the outputs of the backward kernel (``csrc/ssd_wide.cu`` too);
- ``grads``: the gradients of the leaves (the torch ops of ``ssd_chunked``
  around the kernels included);
- ``cpu``: the CPU's plain autograd, the test's yardstick, run each
  iteration too;

and holds each iteration's gradients against the CPU's with the test's
tolerance.  By default the card test file runs first in the same process,
since an earlier test may leave state behind, and the TF32 settings are
printed before and after it.  Run from the repository root on a card:

    PYTHONPATH=src python tools/ssd_grad_determinism.py --iters 200

``--no-pytest`` skips the test file; ``--sanitize TOOL`` reruns this script
(2 iterations, no test file) under ``compute-sanitizer --tool TOOL`` limited
to the ssd kernels, where the toolkit has it.  The last line is a JSON
summary, with a digest of each stage's first-iteration bits, so that runs
in separate processes can be compared too.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

# tests/test_torch_cuda_kernels.py's backward tolerance for float32
RTOL, ATOL = 1e-4, 1e-5


def tf32_state() -> dict:
    return dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                float32_matmul_precision=torch.get_float32_matmul_precision())


def leaves_of_the_test(dev):
    """The test's inputs, drawn as it draws them (seed 13, on the card)."""
    gen = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    L, H, P, N = 300, 8, 64, 128
    leaves = [rnd(2, L, H, P), torch.nn.functional.softplus(rnd(2, L, H) - 1), -torch.exp(rnd(H) * 0.2),
              rnd(2, L, 1, N), rnd(2, L, 1, N), rnd(2, H, N, P)]
    dy, ds = rnd(2, L, H, P), rnd(2, H, N, P)
    return leaves, dy, ds


def grads(leaves, dy, ds, device, record=None):
    ts = [t.detach().to(device).requires_grad_() for t in leaves]
    y, s = ssd_ops.ssd_chunked(*ts[:5], 128, ts[5])
    out = torch.autograd.grad((y * dy.to(device)).sum() + (s * ds.to(device)).sum(), ts)
    if record is not None:
        record["grads"] = [g.detach().clone() for g in out]
    return out


def recording(record):
    """Wrap the forward and backward kernel calls of ``SsdIntraChunkFn`` so
    that their inputs and outputs land in ``record``."""
    fwd, bwd = ssd_ops._intra_chunk_kernel, ssd_ops.ssd_intra_chunk_bwd

    def fwd_spy(*args):
        out = fwd(*args)
        record["fwd"] = [t.detach().clone() for t in out]
        return out

    def bwd_spy(*args):
        record["bwd_in"] = [t.detach().clone() for t in args[5:]]
        out = bwd(*args)
        record["bwd"] = [t.detach().clone() for t in out]
        return out

    return fwd_spy, bwd_spy, (fwd, bwd)


def run_loop(iters: int, dev: str = "cuda") -> dict:
    dev = torch.device(dev)
    leaves, dy, ds = leaves_of_the_test(dev)
    record: dict = {}
    fwd_spy, bwd_spy, saved = recording(record)
    ssd_ops._intra_chunk_kernel, ssd_ops.ssd_intra_chunk_bwd = fwd_spy, bwd_spy
    first, differs, misses, worst = None, {}, 0, 0.0
    try:
        for it in range(iters):
            grads(leaves, dy, ds, dev, record)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            cpu = [g.detach() for g in grads(leaves, dy, ds, "cpu")]
            now = {k: [t.cpu() for t in v] for k, v in record.items()}
            now["cpu"] = cpu
            if first is None:
                first = now
            for stage, ts in now.items():
                for i, (a, b) in enumerate(zip(ts, first[stage])):
                    if not torch.equal(a, b):
                        n = int((a != b).sum())
                        differs.setdefault(f"{stage}[{i}]", []).append((it, n))
            # the test's check: every gradient within rtol·|cpu| + atol·max|cpu|
            for g, w in zip(now["grads"], cpu):
                lim = RTOL * w.abs() + ATOL * float(w.abs().max())
                err = (g - w).abs()
                bad = int((err > lim).sum())
                misses += bad
                worst = max(worst, float((err / lim.clamp_min(1e-30)).max()))
            if it % 50 == 0:
                print(f"[f2] iteration {it}: stages that differ from iteration 0 so far: "
                      f"{sorted(differs) or 'none'}", flush=True)
    finally:
        ssd_ops._intra_chunk_kernel, ssd_ops.ssd_intra_chunk_bwd = saved
    digest = {stage: hashlib.sha256(b"".join(t.numpy().tobytes() for t in ts)).hexdigest()[:16]
              for stage, ts in first.items()}
    return dict(iters=iters, stages_compared=sorted(first), differing=differs,
                elements_outside_the_test_tolerance=misses, worst_share_of_the_limit=worst,
                first_iteration_digest=digest)


def sanitize(tool: str) -> dict:
    exe = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(exe).exists():
        return dict(tool=tool, ran=False, why="compute-sanitizer not found")
    cmd = [exe, "--tool", tool, "--kernel-name", "kns=ssd_", "--error-exitcode", "9",
           sys.executable, str(Path(__file__).resolve()), "--iters", "2", "--no-pytest"]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        return dict(tool=tool, ran=False, why="timed out after 300 s")
    tail = (p.stdout + p.stderr).strip().splitlines()[-12:]
    return dict(tool=tool, ran=True, rc=p.returncode, tail=tail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--no-pytest", action="store_true", help="skip the card test file before the loop")
    ap.add_argument("--sanitize", action="append", default=[], help="racecheck, synccheck, ...")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_grad_determinism: no CUDA device", file=sys.stderr)
        return 1
    out = dict(tf32_at_start=tf32_state())
    if not args.no_pytest:
        import pytest

        rc = pytest.main(["-q", "-m", "cuda", "-p", "no:cacheprovider",
                          str(ROOT / "tests" / "test_torch_cuda_kernels.py")])
        out.update(pytest_rc=int(rc), tf32_after_tests=tf32_state())
    out["loop"] = run_loop(args.iters)
    out["sanitizers"] = [sanitize(t) for t in args.sanitize]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
