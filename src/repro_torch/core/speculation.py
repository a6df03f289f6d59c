"""Speculative execution over uncertain data accesses (paper §4.6, [Bramas'19]).

``SpMaybeWrite`` marks a task as an *uncertain writer*: at insertion time it
is unknown whether it will modify the data.  In a speculative graph
(``SpSpeculativeModel.SP_MODEL_1``) the runtime then rewrites the stream so
that a later reader can run *in parallel with* the uncertain writer:

  insertion stream        rewritten graph
  ---------------         ----------------------------------------------
  U: maybe-write X        C: read X → write X̂      (snapshot, pre-U value)
                          U: maybe-write X          (unchanged)
  R: read X, write Y      CY: read Y → write Ŷ      (pre-R value of Y)
                          R̂: read X̂ → write Ŷ, r̂   (speculative body)
                          K: read X (post-U), read Ŷ → write Y
                             commit Ŷ→Y if U did not write (r ← r̂),
                             else re-run R's body on the real X (rollback)

Because JAX arrays are immutable, snapshots are reference copies — the cost
of speculation here is task-management overhead plus possible re-execution,
never a deep copy.

The paper's two speculative models are both implemented:

* ``SP_MODEL_1`` — speculate past the most recent uncertain writer only;
  chained maybe-writers each get a fresh snapshot taken *after* the
  previous writer resolves (readers overlap one writer at a time).
* ``SP_MODEL_2`` — speculate past whole *chains*: one snapshot before the
  first writer of the chain, readers overlap every writer, commit checks
  them all (more overlap, more rollback exposure — the paper's trade-off).

Commutative/atomic accesses and array views in the reader bail out to
normal insertion.  Communication tasks refuse speculation entirely (paper
§4.4 limitation, enforced in ``comm.py``).

Speculative **decoding** (``repro.serving.spec`` in the JAX package; not yet ported) is this machinery applied
to LM serving — the mapping from the paper's abstractions to the decoder:

* each *draft* step is an uncertain writer (``maybe``) on the engine's
  per-batch decode-state cell: it proposes tokens with a cheap draft model
  and normally leaves the real state untouched (``written == False``); it
  writes only to poison the round when the scheduler sheds speculation or
  a rollback is forced;
* the *verify* task reads that cell, so under ``SP_MODEL_2`` it overlaps
  the whole k-deep draft chain, running the target model's batched
  multi-position forward against the chain's shared snapshot;
* *commit* performs the certain WRITE that clears the uncertainty marker
  and publishes accepted tokens + KV rows — or, when a drafter wrote, the
  runtime re-runs verify's body on the real state (rollback) before commit
  sees its output, exactly case (b) above.

Acceptance/rejection of individual drafted tokens happens *inside* the
verify body (committed tokens are always the target model's own samples,
which keeps greedy and seeded-sampling decode bit-exact with the
non-speculative engine); the graph-level commit/rollback handles the
coarser question of whether the whole round's snapshot was stale.
"""
from __future__ import annotations

from typing import Any, Optional

from .access import AccessMode, SpAccess, SpData
from .task import Task, TaskView


def _copy_task(graph, src: SpData, dst: SpData, tag: str) -> Task:
    """Insert a hidden snapshot task: dst.value ← src.value (reference copy)."""

    def body(src_val, dst_ref):
        dst_ref.value = src_val

    t = Task(
        {"ref": body},
        [SpAccess(src, AccessMode.READ), SpAccess(dst, AccessMode.WRITE)],
        [("single", SpAccess(src, AccessMode.READ)),
         ("single", SpAccess(dst, AccessMode.WRITE))],
        name=f"spec-copy[{tag}]",
        cost=0.01,
    )
    # NB: accesses in Task and arg_layout must be the *same* SpAccess objects
    t.arg_layout = [("single", t.accesses[0]), ("single", t.accesses[1])]
    graph._insert(t)
    return t


def maybe_speculative_insert(
    graph,
    impls: dict,
    accesses: list[SpAccess],
    arg_layout: list[tuple[str, Any]],
    priority: int,
    name: str | None,
    cost: float,
) -> Optional[TaskView]:
    """Called by ``SpTaskGraph.task`` before normal insertion.

    Returns a TaskView if the insertion was handled speculatively (either as
    an uncertain writer or as a speculated reader); None to fall through to
    normal insertion.
    """
    maybe_accs = [a for a in accesses if a.mode is AccessMode.MAYBE_WRITE]

    # Any certain write clears the uncertainty marker: later readers must see
    # the certain writer's value, never speculate against the stale snapshot.
    for a in accesses:
        if a.mode in (AccessMode.WRITE, AccessMode.COMMUTATIVE_WRITE, AccessMode.ATOMIC_WRITE):
            a.data._uncertain_writer = None

    # ---- Case A: this task is an uncertain writer --------------------------
    if maybe_accs:
        from .graph import SpSpeculativeModel

        chain = graph.spec_model is SpSpeculativeModel.SP_MODEL_2
        snaps: dict[int, SpData] = {}
        prior: dict[int, list] = {}
        for a in maybe_accs:
            uw = a.data._uncertain_writer
            if chain and uw is not None:
                # MODEL 2: extend the uncertain chain — reuse the snapshot
                # taken before the FIRST writer; readers overlap all of them
                prior[a.data.uid] = list(uw[0])
                snaps[a.data.uid] = uw[1]
            else:
                snap = SpData(None, name=f"{a.data.name}.snap")
                _copy_task(graph, a.data, snap, a.data.name)
                prior[a.data.uid] = []
                snaps[a.data.uid] = snap
        task = Task(impls, accesses, arg_layout, priority, name, cost=cost)
        view = graph._insert(task)
        for a in maybe_accs:
            a.data._uncertain_writer = (prior[a.data.uid] + [task], snaps[a.data.uid])
        return view

    # ---- Case B: reader of uncertain data -> speculate ---------------------
    uncertain_reads = [
        a
        for a in accesses
        if a.mode is AccessMode.READ and a.data._uncertain_writer is not None
    ]
    if not uncertain_reads:
        return None
    # bail out on shapes we do not speculate on
    if any(kind == "array" for kind, _ in arg_layout):
        return None
    if any(
        a.mode in (AccessMode.COMMUTATIVE_WRITE, AccessMode.ATOMIC_WRITE)
        for a in accesses
    ):
        return None

    graph.spec_stats["speculated"] += 1
    # uid → (writer task list, snapshot cell)
    writers = {a.data.uid: a.data._uncertain_writer for a in uncertain_reads}

    writes = [a for a in accesses if a.mode is AccessMode.WRITE]
    reads_certain = [
        a
        for a in accesses
        if a.mode is AccessMode.READ and a.data.uid not in writers
    ]

    # snapshot each written cell's pre-value (so the speculative body mutates
    # a shadow, never the real cell)
    shadow: dict[int, SpData] = {}
    for a in writes:
        y_spec = SpData(None, name=f"{a.data.name}.shadow")
        _copy_task(graph, a.data, y_spec, a.data.name)
        shadow[a.data.uid] = y_spec

    res_cell = SpData(None, name=f"{name or 'task'}.res")
    fn = impls.get("ref") or next(iter(impls.values()))

    # ---- speculative body R̂ -------------------------------------------------
    spec_accesses: list[SpAccess] = []
    spec_slot_for: list[SpAccess] = []  # aligned with original arg_layout
    for kind, acc in arg_layout:
        if acc.mode is AccessMode.READ and acc.data.uid in writers:
            s = SpAccess(writers[acc.data.uid][1], AccessMode.READ)  # snapshot
        elif acc.mode is AccessMode.READ:
            s = SpAccess(acc.data, AccessMode.READ)
        else:  # WRITE → shadow
            s = SpAccess(shadow[acc.data.uid], AccessMode.WRITE)
        spec_accesses.append(s)
        spec_slot_for.append(s)
    res_acc = SpAccess(res_cell, AccessMode.WRITE)
    spec_accesses.append(res_acc)

    def spec_body(*args):
        *user_args, res_ref = args
        res_ref.value = fn(*user_args)

    spec_task = Task(
        {"ref": spec_body},
        spec_accesses,
        [("single", a) for a in spec_accesses],
        priority,
        name=f"{name or 'task'}.spec",
        cost=cost,
        speculative=True,
    )
    graph._insert(spec_task)

    # ---- commit / rollback K -------------------------------------------------
    # access order: [uncertain X (post-U) ...] [certain Z ...] [shadow Ŷ ...]
    #               [res_cell] [Y writes ...]
    k_accesses: list[SpAccess] = []
    x_accs = [SpAccess(a.data, AccessMode.READ) for a in uncertain_reads]
    z_accs = [SpAccess(a.data, AccessMode.READ) for a in reads_certain]
    s_accs = [SpAccess(shadow[a.data.uid], AccessMode.READ) for a in writes]
    r_acc = SpAccess(res_cell, AccessMode.READ)
    y_accs = [SpAccess(a.data, AccessMode.WRITE) for a in writes]
    k_accesses = x_accs + z_accs + s_accs + [r_acc] + y_accs

    n_x, n_z, n_s = len(x_accs), len(z_accs), len(s_accs)
    uncertain_uids = [a.data.uid for a in uncertain_reads]
    writer_tasks = {uid: list(writers[uid][0]) for uid in uncertain_uids}

    # map original slots → (source, index) for the rollback re-execution
    plan: list[tuple[str, int]] = []
    xi = {a.data.uid: i for i, a in enumerate(uncertain_reads)}
    zi = {a.data.uid: i for i, a in enumerate(reads_certain)}
    yi = {a.data.uid: i for i, a in enumerate(writes)}
    for kind, acc in arg_layout:
        if acc.mode is AccessMode.READ and acc.data.uid in xi:
            plan.append(("x", xi[acc.data.uid]))
        elif acc.mode is AccessMode.READ:
            plan.append(("z", zi[acc.data.uid]))
        else:
            plan.append(("y", yi[acc.data.uid]))

    def commit_body(*args):
        xs = args[:n_x]
        zs = args[n_x : n_x + n_z]
        shs = args[n_x + n_z : n_x + n_z + n_s]
        res_val = args[n_x + n_z + n_s]
        y_refs = args[n_x + n_z + n_s + 1 :]
        rolled = any(
            w.maybe_written.get(uid, False)
            for uid in uncertain_uids
            for w in writer_tasks[uid]
        )
        if not rolled:
            graph.spec_stats["commits"] += 1
            for ref, sh in zip(y_refs, shs):
                ref.value = sh
            return res_val
        graph.spec_stats["rollbacks"] += 1
        call_args = []
        for src, i in plan:
            if src == "x":
                call_args.append(xs[i])
            elif src == "z":
                call_args.append(zs[i])
            else:
                call_args.append(y_refs[i])
        return fn(*call_args)

    commit = Task(
        {"ref": commit_body},
        k_accesses,
        [("single", a) for a in k_accesses],
        priority,
        name=name or f"task{spec_task.uid}.commit",
        cost=0.05,
    )
    return graph._insert(commit)
