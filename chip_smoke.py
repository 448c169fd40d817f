#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. setup: the card's name and power limit; build the three hand-written
   kernel libraries (``support_fine.cu``, ``peel_fused.cu`` and
   ``support_dense.cu`` from ``src/repro_torch/kernels/csrc``) and
   ``graph_while.cu`` (the WHILE conditional node of the unfused peel's
   trip graph), one ``nvcc`` each, started together, and print nvcc's register,
   shared-memory and spill reports, the fused kernel's CTAs per SM (its
   cooperative grid), the dense product's dynamic shared memory and the
   CUDA runtime and driver versions the conditional nodes run on.
2. kernel vs plain version, at the main path's input: ``rmat-15``
   (``configs.LARGE_GRAPHS``) packed as phase 3 packs it (8 slots of its
   bucket, 3 live); ``support_fine_cuda`` must equal the plain torch
   ``support_fine_owner`` bit for bit on the full alive mask and three
   seeded random masks.  Times the kernel, the plain version and a
   ``torch.sparse`` yardstick; computes the kernel's bound; prints the
   kernel's work items per mask.  After phase 3, the same check and
   timing on three alive sets of phase 3's peel (its first, middle and
   last trip), each beside ``support_steps`` and its bound.
3. the support kernel's path, full size: ``decompose``/``kmax``/
   ``ktruss(k=4)`` of ``rmat-15`` through ``Session`` on CUDA with
   ``backend="fine/pallas/aligned"``; its first dispatch captures the
   unfused peel's trip graph (the capture's host ms is printed); checks
   one dispatch, one capture, that the kernel ran once per peel trip (on
   the graph path the kernel counts its own launches on the device), and
   the results against each other and the numpy oracle; then the batch
   again on the same session (a replay, no capture).  Then the same batch
   through a fresh executor alone (the graph: its first dispatch with the
   capture and the memory it reserved, then warm dispatches) beside the
   peel driven by hand through
   ``_peel_step`` one trip at a time, each support pass between CUDA
   events (the split into the kernel's passes and the rest of the trips,
   and the lanes handed to the kernel, are measured on this eager loop
   only), the states equal field for field; and, at the very end of the
   run (the profiler slows every later launch of the process), the peel
   under ``torch.profiler``: the profiler does not trace inside the
   graph's WHILE node, so the trips' device work is read from the same
   trips driven by hand, and the graph's busy share is that over a warm
   graph dispatch's wall; its readbacks and the kernels with the most
   device time, none of them ``index_add_``'s (the per-slot sums are row
   sums).
4. every ``configs.BENCH_GRAPHS`` graph decomposed through
   ``fine/fused/aligned`` and ``fine/pallas/aligned``, and those whose
   bucket window is at most 64 also through ``fine/xla/aligned``;
   trussness must agree bit for bit, and equal ``trussness_numpy`` on
   er-4k and clustered-32x40.  Then each graph's
   bucket is swept by ``autotune_fused`` over every autotune candidate,
   timed and not stored.
5. main path, full size: the same rmat-15 batch through ``Session`` with
   the backend left to the auto rule, which must pick
   ``fine/fused/aligned``; checks one dispatch, one kernel launch per level
   step (``peel_fused_levels``), and the results against phase 3's.
6. the fused kernel vs its plain version on rmat-15's first level (the
   main path's packed batch): every state field bit for bit; prints the
   kernel's worklist per inner trip (unsplit and split lanes) and its
   split work items; times the kernel, the plain version and the bound
   (each input read once, each output written once; the intersection
   steps of every inner trip's alive set); times each level launch of the
   whole peel, and sums the kernel's own clock over its phases.  Then the state
   of the whole fused peel, for every autotune candidate, must equal the
   ``fine/pallas/aligned`` executor's
   on every field but ``total_iters``; each candidate's peel and the
   pallas peel are timed on the same batch.
7. the dense kernel at full width: rmat-15's dense symmetric adjacency
   (1-based, n + 1 = 32,769 rows, padded to 32,896), built on the card,
   through ``kernels.ops.support_dense``; ``support_dense_cuda`` must equal
   ``support_dense_torch`` bit for bit there and on an asymmetric random
   0/1 matrix at V = 4,096, and ``S`` at every edge must equal
   ``support_fine_cuda`` with every lane alive (zero off the edges).
   Times the kernel, the plain version and ``torch._int_mm`` with the mask
   as the yardstick; computes the bound; prints peak memory and the share
   of the call spent making Uᵀ (the library's transpose kernel, beside
   torch's ``u.t().contiguous()``).
8. ``KTrussEngine`` on the card: rmat-15 at full width, fine/owner/pallas;
   ``ktruss(4)``, ``kmax()``, ``decompose()`` and ``peel_levels()`` must
   equal phase 3's answers, through ``support_fine_cuda``.  Then the
   quickstart's grid (coarse/eager/xla, fine/eager/xla, fine/owner/xla,
   fine/owner/pallas, bucketed) on ``ENGINE_GRID_GRAPH``: all agree on
   ``ktruss(4)``; each one's ``support()`` time and ME/s (the paper's
   Table I in miniature).
9. streaming K-truss on rmat-15 (``repro_torch.stream``): ``edge_triangles``
   on the card, timed, its count (3T) equal to the sum of
   ``support_fine_cuda`` over every real lane and its triples equal to the
   CPU's in order; one stream on ``Session(max_batch=8)`` (the auto rule:
   ``fine/fused/aligned``) seeded by an empty update (its one full
   enumeration), then two balanced batches at each width 1, 16 and 256,
   each update bit for bit equal to a from-scratch decompose on
   ``fine/pallas/aligned``, every edge whose trussness changed inside the
   frontier (recomputed by a full enumeration), with its wall, spans and
   bytes copied each way (the first and the warm batch of each width
   apart), the first batch's delta and frontier on the card held field
   by field against ``device="cpu"``'s;
   ``fused_level_cuda``'s first level and ``support_fine_cuda`` on
   ``alive | frozen-live`` against their plain versions on two updates'
   lowered inputs (the first width-256 batch, the first width-1 batch);
   8 streams' updates on one session coalescing into one dispatch, then
   their ``submit_update`` timed alone and while another session's
   ``fine/pallas/aligned`` replay holds the card (these two rounds'
   launches are printed apart, not counted); a
   checkpoint restored on the card that continues identically without a
   full enumeration; ``TrussService(backend="pallas")``'s
   ``submit_stream`` and ``open_stream`` equal to the stream.  The
   kernels' launches by these stream calls join their ``launches``.
10. resilience and the serving fleet on the card, rmat-15 at full width.
   The phase-5 batch through ``Session(max_batch=8)`` (auto rule:
   ``fine/fused/aligned``) under five faults, each case's answers equal to
   phase 5's wherever a query succeeds: an injected ``compile`` fault on
   ``fine/fused/aligned`` (the batch lands on ``fine/pallas/aligned``:
   ``support_fine_cuda`` runs that peel's trips, the fused kernel none); an
   injected ``dispatch`` fault (one retry, the fused kernel launched once
   per level step); the kmax query poisoned (only it fails, typed); and a
   real kernel fault: the fused library's launch symbol wrapped to return
   ``cudaErrorCooperativeLaunchTooLarge`` through the wrapper's own error
   path, so every query fails with ``QueryFailedError`` caused by
   ``DeviceError(site="fused_level")`` with no retry, no fallback, no
   support-kernel launch and no call of the plain level, and the same
   session serves the batch correctly once the symbol is restored; and a
   real OOM allocating the fused kernel's scratch (its sizing asks for 4
   TiB), failing every query the same way with nothing else run.  Then
   ``Fleet(2, device="cuda", max_batch=8)``, both replicas warmed on
   rmat-15 from the kernel libraries phase 1 built (no new file in
   ``kernels/_build/``): ``FleetClient.solve`` equal to phase 5, every
   replica's health report holding rmat-15's bucket, the router's
   accounting adding up, and a stream on rmat-15 fed one of phase 9's
   width-16 batches, its owner killed, the second batch applied on the
   survivor (``seq == 2``) equal to an in-process stream fed both.  The
   in-process launches of phase 10 join the kernels' ``launches``.
11. the mesh path (``repro_torch.distributed``) on rmat-15: the phase-5
   batch on ``Session(max_batch=8, mesh=slot_mesh())`` (the auto rule
   must plan ``fine/pallas/aligned``: a mesh refuses the fused kernel);
   the batch twice over (6 live slots) on ``slot_mesh()`` and on two
   shards of ``cuda:0``, 4 slots each; the batch through
   ``TrussService(backend="pallas", mesh=slot_mesh())``; and width-16
   stream updates on a mesh session (one stream on ``slot_mesh()``, then
   two streams coalesced on two shards of ``cuda:0``, one slot each, so
   that a rebased shard's frozen lanes reach the kernel), each equal to a
   from-scratch
   ``fine/pallas/aligned`` decompose.  Each case is one dispatch whose
   answers equal phase 5's bit for bit, with ``support_fine_cuda``
   launched once per trip of every shard that holds a member (a shard's
   trips: the longest run of its slots), and no fused launch; each
   case's wall is printed beside phase 3's.  Then the recompile sentinel
   (``repro_torch.analysis.sentinel``): phase 5's batch on a fresh session
   builds one executor and no kernel (and, forced onto
   ``fine/pallas/aligned``, captures one trip graph), its warm repeat
   builds and captures nothing; and ``python -m repro_torch.analysis``
   exits 0 on this copy of the tree.  The launches of phase 11 join ``support_fine_cuda``'s.
12. the five example twins (``repro_torch.examples``) on the card: (a) each
   one's ``main(device="cuda")`` at the example's own size, with its own
   checks (the quickstart grid agrees on ``ktruss(4)``, every stream step
   equals a from-scratch decompose) and the answers of
   ``declarative_queries`` and ``tracing`` against ``trussness_numpy``;
   each one's output, planner backends and launches of the two peel
   kernels are printed; the one-shot solve of ``declarative_queries`` must
   launch ``fused_level_cuda`` once a level and ``quickstart``'s
   ``fine/owner/pallas`` ``support_fine_cuda`` once a ``ktruss(4)`` trip
   and once for its timed pass; (b) ``ktruss_scaling.sweep`` over every
   ``configs.BENCH_GRAPHS`` graph with ``coarse/eager/xla``,
   ``fine/eager/xla`` and ``fine/owner/pallas`` (each coarse pass's padded
   size printed first; median of 3 warm support passes, CUDA events), the
   three settings equal on ``ktruss(4)``, ``support_fine_cuda`` launched
   once a trip and once a timed pass, each graph's coarse/fine ratios
   beside ``max_degree / avg_degree`` and ``coarse_imbalance``; (c) the
   card's aligned pack of phase 5's batch equal to ``device="cpu"``'s field
   by field, its ms a member and the bytes it copies to the card, then
   ``tracing.traced_solve`` on phase 5's batch in a fresh traced
   ``Session(max_batch=8)`` (auto rule: ``fine/fused/aligned``), cold then
   warm, each span's ms and ``solve`` outside its child spans, the answers
   equal to phase 5's, one fused launch a level, no retry and no fallback;
   then ``Session.submit``'s latency (the auto rule's statistics) alone and
   while another thread's solve of the batch, pinned to the fused and then
   to the unfused peel, is in its dispatch.
   No resilience counter may move over phase 12.  Phase 12's launches are
   the kernels' ``launches_by_path["examples"]``.
13. the balanced-graph main path at full width: ``road-512``
   (``configs.LARGE_GRAPHS``: 262,144 vertices, 536,383 edges) and its
   three-query batch, its card's pack first checked against
   ``device="cpu"``'s as in phase 12 (c), through ``Session(max_batch=8)``
   with the auto rule, which must plan ``fine/pallas/aligned`` (one
   dispatch, ``support_fine_cuda`` once a trip); the answers against
   ``trussness_numpy``; the wall (with the capture), trips and
   readbacks, and a warm repeat; the batch through a fresh traced
   session, cold then warm, split by span (``plan``, ``pack``,
   ``compile``, ``dispatch``, ``unpack``, outside; the bytes the unpack
   and the whole solve read back), its answers equal to
   the first session's and ``support_fine_cuda`` once a trip in each run
   (these launches are not the main path's count); the submit latency as
   in phase 12 (c); then the graph peel beside the eager loop's split as
   in phase 3.
14. the contig layout: rmat-15's and road-512's three-query batches
   through ``Session(max_batch=8, backend="fine/pallas/contig")``, one
   dispatch each, ``support_fine_cuda`` once a trip, every answer bit for
   bit the aligned path's (phase 5's; a ``fine/pallas/aligned`` session's
   on road-512), and a warm repeat replaying the trip graph. Its launches
   are ``launches_by_path["phase14_contig"]``.

Each span split (phases 12 (c) and 13) also counts the solve's copies to
the card and its readbacks, in all and inside ``plan`` and ``pack``.

Phases 9, 10 and 11 print the trip-graph captures made in this process
while they ran: how many, and their host seconds.

Phases 1-9 must end with no retry, fallback, injected fault or quarantine
in any session they drive (checked before phase 10 over the process-wide
metrics registry, which every session's counters add to); the script
refuses to start when ``REPRO_FAULTS`` is set.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches on its paths (``launches`` is their sum,
``launches_by_path`` the count of each phase that drove it, each read with
the counts zeroed just before) and its times.

    python3 chip_smoke.py --mesh-only

runs phases 1, 3, 5 and 11 alone; on a machine with several cards,
``slot_mesh()`` spans them all.  It is for timing the mesh path only: it
holds no kernel against its plain version and prints neither the
``kernels`` line nor the ``{"ok": true, ...}`` line.

    python3 chip_smoke.py --prep-only [--src DIR]

runs phase 1, then the packs, span splits and submit latencies of phase 12
(c) (rmat-15) and phase 13 (road-512) alone, and each batch's stage split
(``stage_split``: ``plan`` and ``pack`` by stage, each between two
synchronizations, host and device ms), with the ``repro_torch`` under
``DIR``, and prints them as one ``prep`` JSON line: for comparing two
trees' graph preparation in one session.  No kernel check, no result line.

    python3 chip_smoke.py --stream-only [--src DIR]

runs phase 1, then phase 9's stream updates (the span split by width,
first and warm, the bytes copied each way, the card's delta and frontier
against the CPU's where the tree builds them on a device) and its
coalesced, lone and concurrent ``submit_update`` rounds, with the
``repro_torch`` under ``DIR``, and prints them as one ``stream`` JSON
line.  No kernel check, no result line.

    python3 chip_smoke.py --support-only --sets FILE [--src DIR]

runs phase 2 and phase 3's split alone, with the ``repro_torch`` under
``DIR`` (another tree's ``src``, to compare two trees' kernels in one
session); the peel's alive sets come from ``FILE`` when it exists, and are
written there otherwise, so that every tree is timed on the same sets.
Imports nothing of JAX or of the JAX package.  Needs one CUDA card; exits
non-zero without one, or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor peak, the table's float32 row
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
SEED_MASKS = (101, 202, 303)
XLA_MAX_WINDOW = 64  # phase 4 runs fine/xla/aligned on buckets this narrow
ENGINE_GRID_GRAPH = "ba-6k"  # BENCH_GRAPHS: skewed (coarse imbalance 395), coarse O(n·W²) still quick


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), warm."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def support_steps(p, alive) -> float:
    """Intersection steps ``support_fine`` needs on this alive set: per
    alive edge the cheaper of a merge, deg(a)+deg(b), and a binary search
    of the shorter row in the longer, min*ceil(log2(max+1))."""
    import torch

    live = (p.colidx != 0) & alive
    da = p.udeg[p.edge_row[live].long()].double()
    db = p.udeg[p.colidx[live].long()].double()
    lo, hi = torch.minimum(da, db), torch.maximum(da, db)
    return float(torch.minimum(da + db, lo * torch.ceil(torch.log2(hi + 1))).sum())


def roofline(nbytes: float, ops: float, ops_per_s: float = INT_OPS_PER_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    given peak (default the non-tensor one), in ms, and which of the two
    it is."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def support_bound(p, alive) -> tuple[float, str, float, float]:
    """Least time for ``support_fine`` on these inputs: bytes (each input
    read once, the output written once) vs ``support_steps``."""
    nbytes = (
        p.edge_row.numel() * 4 + p.colidx.numel() * 4 + alive.numel() * 1
        + p.urowptr.numel() * 4 + p.udeg.numel() * 4
        + p.ucolidx.numel() * 4 + p.u2d.numel() * 4
        + p.colidx.numel() * 4  # the (nnz_pad,) int32 output
    )
    ops = support_steps(p, alive)
    return (*roofline(nbytes, ops), nbytes, ops)


def sparse_yardstick(p, alive):
    """One torch.sparse expression for the same supports:
    ``(A @ A) ∘ A`` on the symmetric alive adjacency, read at A's entries
    and mapped back to directed lanes (for the check, outside the timing)."""
    import torch

    ualive = (p.ucolidx != 0) & torch.cat([alive, alive.new_zeros(1)])[p.u2d.clamp(max=p.nnz_pad).long()]
    rows, cols = p.uedge_row[ualive].long(), p.ucolidx[ualive].long()
    n = p.n + 1
    a = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.ones(rows.numel(), device=rows.device), (n, n),
        check_invariants=False,
    ).coalesce()

    def run():
        return torch.sparse.mm(a, a).sparse_mask(a)

    order = torch.argsort(rows * n + cols)  # coalesced order of A's entries
    lanes = p.u2d[ualive][order].long()
    return run, lanes


def phase_setup(torch):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.graph_while import cuda_versions, load_graph_while
    from repro_torch.kernels.peel_fused import load_peel_fused
    from repro_torch.kernels.support_dense import load_support_dense
    from repro_torch.kernels.support_fine import load_support_fine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    loaders = {
        "support_fine": load_support_fine,
        "peel_fused": load_peel_fused,
        "support_dense": load_support_dense,
        "graph_while": load_graph_while,
    }
    with ThreadPoolExecutor(len(loaders)) as pool:  # one nvcc per source, together
        futs = {name: pool.submit(fn) for name, fn in loaders.items()}
        built = {name: f.result() for name, f in futs.items()}
    log(f"phase1 build: {time.perf_counter() - t0:.2f}s for {len(built)} libraries")
    for name, lib in built.items():
        log(f"phase1 {name}: nvcc {lib.build_s:.2f}s -> {lib.path.name}")
        for line in lib.log.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    for bsearch, schedule in ((0, "compare"), (1, "bsearch")):
        per_sm = built["peel_fused"].lib.peel_fused_blocks_per_sm(bsearch, 8)
        log(f"phase1 peel_fused ({schedule}): {per_sm} CTAs of 256 threads per SM at 8 slots "
            f"(cooperative grid {per_sm} x SMs)")
    log(f"phase1 support_dense: product kernel dynamic shared memory "
        f"{built['support_dense'].lib.support_dense_smem_bytes()} bytes")
    runtime, driver = cuda_versions(built["graph_while"])
    log(f"phase1 graph_while: the WHILE conditional node of the unfused peel's trip graph; CUDA "
        f"runtime {runtime}, driver {driver}")
    return smi


def main_path_problem(g, bucket, slots):
    from repro_torch.graphs import pack_problems

    return pack_problems(
        [g, g, g], slot_n=bucket.n_pad, slot_nnz=bucket.nnz_pad, slots=slots,
        chunk=256, layout="aligned", device="cuda",
    ).problem


def worklist_counts(p, alive) -> str:
    """The kernel's work items and split lanes for ``alive`` (trees whose
    support kernel has no worklist say so)."""
    try:
        from repro_torch.kernels.support_fine import worklist
    except ImportError:
        return "items n/a (no worklist in this tree)"
    wl = worklist(p, alive)
    return f"items {wl.items} ({wl.unsplit.numel()} unsplit lanes + {wl.split.numel()} split lanes)"


def check_support(torch, p, alive, plain, what: str) -> int:
    """``support_fine_cuda`` against its plain version on ``alive``, bit for
    bit; returns the max abs error (0) or raises."""
    from repro_torch.kernels import support_fine_cuda

    got = support_fine_cuda(p, alive)
    want = plain(alive)
    torch.cuda.synchronize()
    e = int((got.long() - want.long()).abs().max())
    log(f"phase2 {what}: alive={int(alive.sum())} max_abs_err={e} sum={int(got.long().sum())}; "
        f"{worklist_counts(p, alive)}")
    if e or not torch.equal(got, want):
        raise AssertionError(f"support_fine_cuda disagrees with its plain version on {what}")
    return e


def phase_kernel(torch, g, bucket) -> dict:
    import numpy as np

    from repro_torch.core import support_fine_owner
    from repro_torch.kernels import support_fine_cuda

    p = main_path_problem(g, bucket, slots=8)
    real = p.colidx != 0
    masks = [real]
    for seed in SEED_MASKS:
        rng = np.random.default_rng(seed)
        keep = torch.from_numpy(rng.random(p.nnz_pad) < rng.uniform(0.3, 0.9)).cuda()
        masks.append(real & keep)
    plain = lambda m: support_fine_owner(p, m, window=bucket.window, chunk=1024)  # noqa: E731
    err = 0
    for i, m in enumerate(masks):
        err = max(err, check_support(torch, p, m, plain, f"mask {i}"))
    alive = masks[0]
    ms = cuda_ms(lambda: support_fine_cuda(p, alive), reps=20)
    plain_ms = cuda_ms(lambda: plain(alive), reps=2)
    bound_ms, bound_by, nbytes, ops = support_bound(p, alive)
    run, lanes = sparse_yardstick(p, alive)
    lib = run()
    ref = support_fine_cuda(p, alive)
    if not torch.equal(lib.values().round().int(), ref[lanes]):
        raise AssertionError("the torch.sparse yardstick disagrees with the kernel")
    del lib
    library_ms = cuda_ms(run, reps=2)
    log(
        f"phase2 support_fine_cuda: {ms:.4f} ms/launch; plain {plain_ms:.2f} ms; "
        f"torch.sparse {library_ms:.2f} ms; bound {bound_ms:.5f} ms by {bound_by} "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} M steps); lanes {p.nnz_pad}, window {bucket.window}"
    )
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


QUERIES = ("decompose", "kmax", "ktruss4")


def rmat15_queries(g):
    from repro_torch.api import TrussQuery

    return [TrussQuery.decompose(g), TrussQuery.kmax(g), TrussQuery.ktruss(g, k=4)]


def run_session(torch, g, **kw):
    """The rmat-15 batch through one ``Session``: futures, wall seconds."""
    from repro_torch.api import Session

    session = Session(device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    futs = [session.submit(q) for q in rmat15_queries(g)]
    session.flush()
    torch.cuda.synchronize()
    return session, futs, time.perf_counter() - t0


def executor_of(session, g, backend: str, *, built: bool = True):
    """The session's executor for ``g``'s bucket on ``backend``: the one its
    dispatch used (``built``), or the one its next dispatch will use."""
    from repro_torch.api import bucket_for, get_backend

    planner = session.planner
    bucket = bucket_for(g, chunk=planner.chunk)
    variant = planner.cache_variant(get_backend(backend).key, bucket, planner.max_batch)
    exe, hit = session.cache.get(bucket, planner.max_batch, variant)
    if built and not hit:
        raise AssertionError(f"no cached {backend} executor for {g.name}")
    return exe


RESILIENCE_KEYS = ("retries", "backend_fallbacks", "faults_injected", "queries_quarantined")


def same_result(name: str, a, b) -> bool:
    """One rmat-15 query's answers equal, bit for bit."""
    if name == "decompose":
        return (a.kmax, a.levels) == (b.kmax, b.levels) and bool((a.trussness == b.trussness).all())
    if name == "kmax":
        return a == b
    return (a.iterations, a.edges_remaining) == (b.iterations, b.edges_remaining) and bool(
        (a.alive == b.alive).all() and (a.support == b.support).all())


def check_rmat15_results(g, futs) -> None:
    from repro_torch.core import support_numpy

    dec, kmax, kt = (f.result() for f in futs)
    if kmax != (dec.kmax if dec.kmax >= 3 else 0):
        raise AssertionError(f"kmax query {kmax} != decompose kmax {dec.kmax}")
    if not (kt.alive == (dec.trussness >= 4)).all():
        raise AssertionError("ktruss(4) mask != (trussness >= 4)")
    s = support_numpy(g, kt.alive)
    if not (s[kt.alive] >= 2).all():
        raise AssertionError("a 4-truss edge has support < 2 under the numpy oracle")


def main_path_slots(torch, bucket, slots: int = 8):
    """The main path's batch layout: slot ids per lane, k0 and single_level
    of decompose, kmax and ktruss(4) in the first three of ``slots``."""
    slot_ids = torch.arange(slots, dtype=torch.int32, device="cuda").repeat_interleave(bucket.nnz_pad)
    k0 = torch.tensor([3, 3, 4] + [3] * (slots - 3), dtype=torch.int32, device="cuda")
    single = torch.tensor([False, False, True] + [False] * (slots - 3), device="cuda")
    return slot_ids, k0, single


class CaptureLog:
    """The unfused peel's trip-graph captures (``PEEL_CAPTURE`` events),
    each with its host seconds (the warm-up and the capture)."""

    def __init__(self):
        self.seconds: list[float] = []

    def __call__(self, event: str, **info) -> None:
        from repro_torch.obs.events import PEEL_CAPTURE

        if event == PEEL_CAPTURE:
            self.seconds.append(info["seconds"])

    def run(self, fn):
        from repro_torch.obs.events import register_event_listener, unregister_event_listener

        register_event_listener(self)
        try:
            return fn()
        finally:
            unregister_event_listener(self)


def with_captures(tag: str, fn):
    """``fn()``, logging the trip-graph captures made in this process while
    it ran (a fleet replica's are its own): how many, and their host time."""
    caps = CaptureLog()
    out = caps.run(fn)
    ms = sorted(x * 1e3 for x in caps.seconds)
    log(f"{tag} trip-graph captures in this process: {len(ms)}, {sum(ms):.1f} ms of host time"
        + (f" (median {ms[len(ms) // 2]:.1f} ms, largest {ms[-1]:.1f} ms)" if ms else ""))
    return out


def same_state(a, b) -> bool:
    """Two peel states equal field for field, bit for bit."""
    import torch

    return all(x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(x, y))
               for x, y in zip(a, b))


def graph_peel(torch, g, bucket, reps: int = 5):
    """``g``'s three-query batch peeled by a fresh ``fine/pallas/aligned``
    executor (no ``Session``): its first dispatch captures the trip graph,
    then ``reps`` warm dispatches replay it.  Returns the problem, the
    executor, the state, the first dispatch's ms and its capture's host ms,
    the memory the first dispatch reserved (MiB, ``memory_reserved`` before
    and after: the graph's pool and static buffers, and whatever else it
    allocated), the warm dispatches' ms (host clock between
    synchronisations) and the readbacks of one warm dispatch."""
    from repro_torch.exec.peel import PeelExecutor

    p = main_path_problem(g, bucket, slots=8)
    slot_ids, k0, single = main_path_slots(torch, bucket)
    kw = dict(slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())
    exe = PeelExecutor(mode="owner", backend="pallas", window=bucket.window, chunk=256)
    caps = CaptureLog()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    st = caps.run(lambda: exe.peel(p, **kw))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    reserved_mib = (torch.cuda.memory_reserved() - reserved) / 2**20
    if len(caps.seconds) != 1:
        raise AssertionError(f"the first dispatch made {len(caps.seconds)} captures")
    warm = []
    for _ in range(reps):
        before = exe.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = caps.run(lambda: exe.peel(p, **kw))
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        if not same_state(st, again):
            raise AssertionError("a warm dispatch of the trip graph != the first")
    if len(caps.seconds) != 1:
        raise AssertionError(f"warm dispatches captured again ({len(caps.seconds)} captures)")
    return p, exe, st, first_ms, caps.seconds[0] * 1e3, reserved_mib, warm, exe.host_syncs - before


def eager_trip_loop(torch, p, bucket, *, timed: bool = True):
    """The main-path batch's unfused peel driven by hand through
    ``_peel_step``, one trip at a time with ``done`` read back after each
    (the eager loop the trip graph replaced), with ``timed`` each support
    pass between two CUDA events.  Returns the state, the whole loop (ms,
    host clock), the support passes' summed device time (ms; 0 untimed),
    and the alive set handed to the kernel on each trip (kept as clones,
    outside the events; none untimed)."""
    from repro_torch.exec import peel as pm
    from repro_torch.kernels import ops

    slot_ids, k0, single = main_path_slots(torch, bucket)
    alive0 = p.colidx != 0
    frozen = torch.zeros_like(alive0)
    ftruss = torch.zeros(alive0.shape, dtype=torch.int32, device=alive0.device)
    events, handed = [], []

    def support(prob, alive):
        if not timed:
            return ops.support_fine(prob, alive, window=bucket.window, chunk=256)
        handed.append(alive.clone())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = ops.support_fine(prob, alive, window=bucket.window, chunk=256)
        end.record()
        events.append((start, end))
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = pm._SlotSums(slot_ids, int(k0.shape[0]), aligned=True)
    st = pm.init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss, sums=sums)
    lanes = slot_ids.long()
    while not bool(st.done.all()):
        st = pm._peel_step(support, p, lanes, sums, single, frozen, ftruss, st)
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    if timed and len(events) != int(st.total_iters):
        raise AssertionError(f"{len(events)} support passes over {int(st.total_iters)} trips")
    return st, whole_ms, sum(a.elapsed_time(b) for a, b in events), handed


def report_peel_split(tag: str, graph, eager) -> None:
    """The executor's graph peel (unless ``graph`` is None) beside the
    hand-driven eager loop, and the eager loop's split into support passes
    and the rest of the trips."""
    est, whole_ms, support_ms, handed = eager
    trips = int(est.total_iters)
    lanes = sum(int(m.sum()) for m in handed)
    if graph is not None:
        _, _, st, first_ms, capture_ms, reserved_mib, warm, syncs = graph
        w = sorted(warm)
        log(f"{tag} executor peel (CUDA graph, one WHILE node, {trips} trips): first dispatch "
            f"{first_ms:.1f} ms, of which the capture {capture_ms:.1f} ms (host), reserving "
            f"{reserved_mib:.0f} MiB; warm dispatch {w[len(w) // 2]:.1f} ms "
            f"[{w[0]:.1f}-{w[-1]:.1f}] (median [min-max] of {len(w)}), {syncs} host syncs a "
            f"dispatch")
        if not same_state(st, est):
            raise AssertionError(f"{tag}: the eager trip loop's state != the graph peel's")
    log(f"{tag} eager trip loop driven by hand (one _peel_step a trip, done read back each "
        f"trip; the split is measured on this loop only: CUDA events and alive.clone() cannot "
        f"sit inside a capture): whole {whole_ms:.1f} ms; support passes {support_ms:.1f} ms of "
        f"device time ({support_ms / trips:.4f} ms a pass); rest of the trips "
        f"{whole_ms - support_ms:.1f} ms ({(whole_ms - support_ms) / trips:.3f} ms a trip); "
        f"lanes handed to the kernel {lanes} over the trips ({lanes / trips:.0f} a trip)"
        + ("; state == the graph peel's, field for field" if graph is not None else ""))


def peel_sets(handed) -> dict:
    """The alive sets of the first trip, the middle trip and the last trip
    that handed the kernel any lane (the top level's core: the trips after
    it prune everything ahead and hand it nothing)."""
    n = len(handed)
    last = max(i for i, m in enumerate(handed) if bool(m.any()))
    return {f"trip {i} of {n}": handed[i] for i in (0, n // 2, last)}


def phase_peel_sets(torch, p, bucket, sets: dict) -> None:
    """``support_fine_cuda`` on alive sets of a real rmat-15 peel: bit for
    bit against its plain version, then timed beside its bound."""
    from repro_torch.core import support_fine_owner
    from repro_torch.kernels import support_fine_cuda

    plain = lambda m: support_fine_owner(p, m, window=bucket.window, chunk=1024)  # noqa: E731
    for name, alive in sets.items():
        check_support(torch, p, alive, plain, f"peel {name}")
        ms = cuda_ms(lambda alive=alive: support_fine_cuda(p, alive), reps=20)
        bound_ms, bound_by, nbytes, ops = support_bound(p, alive)
        log(f"phase2 peel {name}: support_fine_cuda {ms:.4f} ms/call; support_steps {ops / 1e6:.2f} M; "
            f"bound {bound_ms:.5f} ms by {bound_by} ({bound_ms / ms:.1%} of it); "
            f"{worklist_counts(p, alive)}")


def warm_repeat(torch, session, g, futs, tag: str) -> str:
    """The batch again on ``session``: its warm dispatch replays the trip
    graph its first captured (no capture), launching the support kernel
    once a trip, with the first answers.  Returns the log text."""
    from repro_torch.kernels import support_fine_cuda

    caps = CaptureLog()
    launches0 = support_fine_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = caps.run(lambda: session.solve(rmat15_queries(g)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = support_fine_cuda.launches - launches0
    trips = futs[0].stats.dispatch_trips
    if caps.seconds or launches != trips:
        raise AssertionError(f"{tag} warm repeat: {len(caps.seconds)} captures, {launches} "
                             f"support launches over {trips} trips")
    for name, a, f in zip(QUERIES, again, futs):
        if not same_result(name, a, f.result()):
            raise AssertionError(f"{tag} warm repeat: {name} != the first dispatch's")
    return f"warm repeat (replays the graph) {wall:.2f}s wall, {launches} launches, == the first"


def phase_pallas_path(torch, g):
    from repro_torch.kernels import support_fine_cuda

    support_fine_cuda.launches = 0
    caps = CaptureLog()
    session, futs, wall = caps.run(lambda: run_session(torch, g, backend="fine/pallas/aligned"))
    launches = support_fine_cuda.launches
    st = session.stats()
    dec, _, kt = (f.result() for f in futs)
    trips = futs[0].stats.dispatch_trips
    log(
        f"phase3 rmat-15 fine/pallas/aligned: {wall:.2f}s wall (first dispatch; the trip graph's "
        f"capture {sum(caps.seconds) * 1e3:.1f} ms of host time), dispatches "
        f"{st['device_dispatches']}, total_iters {trips}, launches {launches}, host syncs "
        f"{executor_of(session, g, 'fine/pallas/aligned').host_syncs}, levels {dec.levels}, "
        f"kmax {dec.kmax}, ktruss(4) edges {kt.edges_remaining}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    if st["device_dispatches"] != 1 or len(caps.seconds) != 1:
        raise AssertionError(f"{st['device_dispatches']} dispatches for one bucket, "
                             f"{len(caps.seconds)} captures")
    if launches != trips or trips == 0:
        raise AssertionError(f"kernel launched {launches} times over {trips} peel trips")
    check_rmat15_results(g, futs)
    log(f"phase3 {warm_repeat(torch, session, g, futs, 'phase3')}")
    return launches, futs, wall, trips


def profiled_peel(torch, g, bucket, *, check: bool = True) -> None:
    """Phase 3's peel under ``torch.profiler`` (device activity only).  The
    profiler does not trace the kernels inside a conditional node's body,
    so the device's work is read from the same trips driven by hand
    (:func:`eager_trip_loop`, untimed: the same kernels on the same
    inputs, its state equal to the graph's), and the graph peel's idle
    share is one less that busy time over a warm graph dispatch's wall,
    taken without the profiler.  A graph replay is profiled too, to show
    what the profiler sees of it.  Prints the readbacks and the kernels
    that take the most device time.  With ``check``, no ``index_add_``
    kernel may run on the trip (the per-slot sums are row sums).  Run
    last: once the profiler has been active, later launches in the
    process are slower."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.exec.peel import PeelExecutor

    p = main_path_problem(g, bucket, slots=8)
    slot_ids, k0, single = main_path_slots(torch, bucket)
    kw = dict(slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())
    exe = PeelExecutor(mode="owner", backend="pallas", window=bucket.window, chunk=256)
    exe.peel(p, **kw)  # the first dispatch captures the trip graph, outside the profile
    before = exe.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = exe.peel(p, **kw)  # a warm dispatch without the profiler's tracing
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3
    syncs = exe.host_syncs - before

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def device_kernels(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        exe.peel(p, **kw)
        torch.cuda.synchronize()
    seen = device_kernels(prof)
    log(f"phase3 profiled graph replay: the profiler sees {sum(e.count for e in seen)} device "
        f"operations, {sum(device_us(e) for e in seen) / 1e3:.1f} ms (the WHILE node's body "
        f"is not traced)")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        est, eager_ms, _, _ = eager_trip_loop(torch, p, bucket, timed=False)
    if not same_state(est, st):
        raise AssertionError("phase3 profiled peel: the eager trip loop's state != the graph's")
    kernels = device_kernels(prof)
    if not kernels:
        log("phase3 profiled peel: the profiler saw no device time")
        return
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:5]
    log(f"phase3 profiled peel: the trips' device work (the eager loop under the profiler, "
        f"{int(est.total_iters)} trips, {eager_ms:.1f} ms of wall) {busy_ms:.1f} ms; a warm graph "
        f"dispatch without the profiler {graph_ms:.1f} ms with {syncs} host syncs, so the device "
        f"is busy {busy_ms / graph_ms:.1%} of it (idle {1 - busy_ms / graph_ms:.1%}); top kernels "
        f"by device time: " + "; ".join(
            f"{e.key[:60]} {device_us(e) / 1e3:.1f} ms in {e.count} launches "
            f"({device_us(e) / 1e3 / busy_ms:.1%})" for e in top))
    # index_add_'s CUDA kernels are indexFuncSmallIndex / indexFuncLargeIndex.
    atomics = [e.key for e in kernels if "indexFunc" in e.key or "index_add" in e.key]
    if check and atomics:
        raise AssertionError(f"phase3 profiled peel: index_add_ kernels on the trip: {atomics}")


def phase_peel_split(torch, g, bucket, tag: str, session_trips: int | None = None):
    """Phase 3's (or 13's) peel again, through a fresh executor (the graph:
    capture, then warm dispatches) and through the hand-driven eager loop,
    which is split into the support passes and the rest of each trip;
    returns the problem, the graph peel's state and the alive sets handed
    to the kernel."""
    graph = graph_peel(torch, g, bucket)
    p, st = graph[0], graph[2]
    if session_trips is not None and int(st.total_iters) != session_trips:
        raise AssertionError(f"{tag}: executor peel took {int(st.total_iters)} trips, the "
                             f"session's {session_trips}")
    eager = eager_trip_loop(torch, p, bucket)
    report_peel_split(tag, graph, eager)
    return p, st, eager[3]


class Copies:
    """Bytes copied between the host and the card while :meth:`run` runs.
    To the card: through ``Tensor.to``, ``Tensor.cuda`` and
    ``Tensor.copy_`` (every way the port lifts a host array), a count and
    a sum, and each copy with the host time it started. To the host:
    through those, ``Tensor.cpu``, and the readbacks of a CUDA tensor's
    values (``tolist``, ``item``, ``bool()``, ``int()``, ``float()``),
    each with the host time it started (to place it in a span)."""

    READS = ("tolist", "item", "__bool__", "__int__", "__float__")

    def __init__(self):
        self.bytes = 0  # host to card
        self.copies = 0
        self.writes: list[tuple[float, int]] = []  # host to card: (perf_counter s, bytes)
        self.reads: list[tuple[float, int]] = []  # card to host: (perf_counter s, bytes)

    def read_bytes(self, lo: float = float("-inf"), hi: float = float("inf")) -> int:
        """Bytes read back by copies that started in ``[lo, hi)``."""
        return sum(n for t, n in self.reads if lo <= t < hi)

    def within(self, spans) -> dict:
        """Copies each way that started inside any of ``spans`` (trace
        events): bytes and count."""
        def inside(t):
            return any(e["ts"] / 1e6 <= t < (e["ts"] + e["dur"]) / 1e6 for e in spans)

        w = [n for t, n in self.writes if inside(t)]
        r = [n for t, n in self.reads if inside(t)]
        return {"h2d_mb": sum(w) / 1e6, "h2d_copies": len(w), "read_mb": sum(r) / 1e6,
                "readbacks": len(r)}

    def run(self, torch, fn):
        names = ("to", "cuda", "cpu", "copy_") + self.READS
        own = {name: name in torch.Tensor.__dict__ for name in names}
        orig = {name: getattr(torch.Tensor, name) for name in names}

        def counted(name):
            def method(t, *args, **kwargs):
                t0 = time.perf_counter()
                if name in self.READS:
                    if t.is_cuda:
                        self.reads.append((t0, t.numel() * t.element_size()))
                    return orig[name](t, *args, **kwargs)
                out = orig[name](t, *args, **kwargs)
                src = args[0] if name == "copy_" else t
                nbytes = src.numel() * src.element_size()
                if out.is_cuda and not src.is_cuda:
                    self.bytes += nbytes
                    self.copies += 1
                    self.writes.append((t0, nbytes))
                elif src.is_cuda and not out.is_cuda:
                    self.reads.append((t0, nbytes))
                return out
            return method

        for name in names:
            setattr(torch.Tensor, name, counted(name))
        try:
            return fn()
        finally:
            for name, method in orig.items():
                if own[name]:
                    setattr(torch.Tensor, name, method)
                else:
                    delattr(torch.Tensor, name)


# The stages of a query's ``plan`` and a member's ``pack``, as module
# attributes of the ``repro_torch`` that ``--src`` names (a name that
# tree lacks is skipped): (module, attribute, label).
PREP_STAGES = (
    ("repro_torch.api.planner", "bucket_for", "bucket_for (host)"),
    ("repro_torch.api.planner", "lift_csr", "plan: lift"),
    ("repro_torch.api.planner", "undirected_max_degree", "plan: undirected max degree"),
    ("repro_torch.api.planner", "upper_violation", "plan: upper-triangular test"),
    ("repro_torch.api.planner", "imbalance_parts", "plan: imbalance sums"),
    ("repro_torch.api.planner", "imbalance_stats", "imbalance_stats"),
    ("repro_torch.graphs.stats", "lift_csr", "imbalance_stats: lift"),
    ("repro_torch.core.eager_fine", "prepare_fine", "prepare_fine"),
    ("repro_torch.core.eager_fine", "check_upper", "prepare_fine: check_upper"),
    ("repro_torch.core.eager_fine", "lift_csr", "prepare_fine: lift"),
    ("repro_torch.core.eager_fine", "symmetrize_csr", "prepare_fine: symmetrize"),
    ("repro_torch.graphs.pack", "validate_fused_tiling", "validate_fused_tiling"),
)


def stage_split(torch, tag: str, g, reps: int = 3) -> dict:
    """``g``'s three-query batch through a fresh traced auto-rule
    ``Session(max_batch=8)``: once cold, then ``reps`` warm solves with
    every stage of :data:`PREP_STAGES` the tree has timed, the card
    synchronized before and after each call (host clock) and two CUDA
    events around it (device time). Prints, per stage, its calls and the
    median solve's host and device ms; ``prepare_fine``'s rest is its
    time less its own stages'. The synchronizations slow the solve, so the
    spans of these runs are not the span split's."""
    import importlib

    from repro_torch.api import Session
    from repro_torch.examples.tracing import traced_solve

    session = Session(max_batch=8, device="cuda", trace=True)
    traced_solve(session, rmat15_queries(g))
    patched, runs = [], []
    for mod_name, attr, label in PREP_STAGES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr, None)
        if fn is None:
            continue

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            try:
                return _fn(*a, **k)
            finally:
                ev1.record()
                torch.cuda.synchronize()
                row = runs[-1].setdefault(_label, [0, 0.0, 0.0])
                row[0] += 1
                row[1] += (time.perf_counter() - t0) * 1e3
                row[2] += ev0.elapsed_time(ev1)

        setattr(mod, attr, timed)
        patched.append((mod, attr, fn))
    try:
        for _ in range(reps):
            runs.append({})
            _, _, ms = traced_solve(session, rmat15_queries(g))
            runs[-1]["spans"] = [0, ms["plan"], ms["pack"]]
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
    runs.sort(key=lambda r: r["spans"][1] + r["spans"][2])
    mid = runs[len(runs) // 2]
    pf = mid.get("prepare_fine")
    if pf is not None:
        inner = [mid.get(k, [0, 0.0, 0.0]) for k in
                 ("prepare_fine: check_upper", "prepare_fine: lift", "prepare_fine: symmetrize")]
        mid["prepare_fine: rest"] = [pf[0], pf[1] - sum(r[1] for r in inner),
                                     pf[2] - sum(r[2] for r in inner)]
    spans = mid.pop("spans")
    log(f"{tag} stage split (warm, median of {reps} synchronized solves; calls, host ms, "
        f"device ms): " + "; ".join(f"{k} {c}x {h:.3f} / {d:.3f}" for k, (c, h, d) in mid.items())
        + f"; these runs' plan {spans[1]:.2f} ms, pack {spans[2]:.2f} ms")
    return {"stages": {k: {"calls": c, "host_ms": h, "device_ms": d}
                       for k, (c, h, d) in mid.items()},
            "plan_ms": spans[1], "pack_ms": spans[2]}


def check_pack(torch, tag: str, graphs, bucket, slots: int = 8) -> dict:
    """The main path's aligned pack of ``graphs`` on the card against the
    same pack on ``device="cpu"``, field by field; then the card's pack
    timed (host clock to a synchronize, median of 3 warm packs) and the
    bytes it copies to the card.  Returns ms a member, MB copied."""
    from repro_torch.graphs import pack_problems

    def pack(device):
        return pack_problems(graphs, slot_n=bucket.n_pad, slot_nnz=bucket.nnz_pad, slots=slots,
                             chunk=256, layout="aligned", device=device)

    h2d = Copies()
    card = h2d.run(torch, lambda: pack("cuda"))
    cpu = pack("cpu")
    if card.edge_ranges != cpu.edge_ranges:
        raise AssertionError(f"{tag}: the card's pack has other edge ranges than the CPU's")
    for f, a, c in zip(card.problem._fields, card.problem, cpu.problem):
        if not (a.is_cuda and a.dtype == c.dtype and torch.equal(a.cpu(), c)):
            raise AssertionError(f"{tag}: the card's pack differs from the CPU's in {f}")
    del card, cpu
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pack("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(times)[1] / len(graphs)
    log(f"{tag} pack of {len(graphs)} members into {slots} slots: the card's == device='cpu' "
        f"field by field; {ms:.2f} ms a member (median of 3 warm packs, host clock to a "
        f"synchronize: {', '.join(f'{t:.2f}' for t in times)} ms a pack); "
        f"{h2d.bytes / 1e6:.3f} MB copied to the card in {h2d.copies} copies")
    return {"pack_ms_per_member": ms, "h2d_mb": h2d.bytes / 1e6}


# The backends under whose dispatch a submit is timed: rmat-15's auto pick
# (the fused peel, a readback a level) and its longest single replay (the
# unfused peel's trip graph); road-512's auto pick.
SUBMIT_UNDER = {
    "rmat-15": ("fine/fused/aligned", "fine/pallas/aligned"),
    "road-512": ("fine/pallas/aligned",),
}


def span_split(torch, tag: str, g, want, backend: str, counts, trips: int | None = None):
    """``g``'s three-query batch through a fresh traced
    ``Session(max_batch=8)`` (auto rule), cold then warm: each span's ms
    and ``solve`` outside its child spans.  Each run must plan ``backend``
    alone, with no retry and no fallback, and give ``want``'s answers; its
    kernel launches, counted by ``counts`` (zeroed just before the run),
    must be one fused launch a level step (= the decompose's levels) and
    no support launch on ``fine/fused/aligned``, or ``trips`` support
    launches (the batch's trips) and no fused launch on
    ``fine/pallas/aligned``.  Each run also counts the bytes read back
    from the card, by the unpack (the copies made inside its span) and by
    the whole solve.  Returns both runs' ms and MB."""
    from repro_torch.api import Session
    from repro_torch.examples.tracing import SPANS, traced_solve

    session = Session(max_batch=8, device="cuda", trace=True)
    out = {}
    for run in ("cold", "warm"):
        fused0, support0 = counts.fused, counts.support
        levels0 = session.obs.metrics.value("peel_fused_levels")
        copies = Copies()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results, events, ms = copies.run(
            torch, lambda: counts.run(lambda: traced_solve(session, rmat15_queries(g))))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        (unpack,) = [e for e in events if e["ph"] == "X" and e["name"] == "unpack"]
        unpack_mb = copies.read_bytes(unpack["ts"] / 1e6, (unpack["ts"] + unpack["dur"]) / 1e6) / 1e6
        by_span = {s: copies.within([e for e in events if e["ph"] == "X" and e["name"] == s])
                   for s in ("plan", "pack")}
        fused, support = counts.fused - fused0, counts.support - support0
        level_steps = int(session.obs.metrics.value("peel_fused_levels") - levels0)
        for name, a, b in zip(QUERIES, results, want):
            if not same_result(name, a, b):
                raise AssertionError(f"{tag} span split ({run}): {name} differs")
        st = session.stats()
        backends = [c["backend"] for c in st["planner_backends"]]
        if backends != [backend] or st["retries"] or st["backend_fallbacks"]:
            raise AssertionError(f"{tag} span split ({run}): planned on {backends}, "
                                 f"{st['retries']} retries, {st['backend_fallbacks']} fallbacks")
        if backend == "fine/fused/aligned":
            ok = fused == level_steps == results[0].levels and support == 0
        else:
            ok = support == trips and fused == 0
        if not ok:
            raise AssertionError(
                f"{tag} span split ({run}) on {backend}: {fused} fused launches over "
                f"{level_steps} level steps ({results[0].levels} levels), {support} support "
                f"launches over {trips} trips")
        log(f"{tag} span split ({run}), {backends}: " + ", ".join(
            f"{s} {ms[s]:.2f}" for s in SPANS + ("outside",)) + f" ms; wall {wall:.2f} ms; "
            f"fused_level_cuda launches {fused}, support_fine_cuda launches {support}; "
            f"0 retries, 0 fallbacks; answers as expected; unpack read back {unpack_mb:.3f} MB, "
            f"the solve {copies.read_bytes() / 1e6:.3f} MB in {len(copies.reads)} readbacks; "
            f"to the card {copies.bytes / 1e6:.3f} MB in {copies.copies} copies; " + "; ".join(
                f"{s} {c['h2d_mb']:.3f} MB in {c['h2d_copies']} copies to the card, "
                f"{c['readbacks']} readbacks of {c['read_mb'] * 1e3:.3f} kB"
                for s, c in by_span.items()))
        out[run] = {**{s: ms[s] for s in SPANS + ("outside",)}, "wall": wall,
                    "unpack_mb": unpack_mb, "read_mb": copies.read_bytes() / 1e6,
                    "readbacks": len(copies.reads), "h2d_mb": copies.bytes / 1e6,
                    "h2d_copies": copies.copies, "by_span": by_span}
    return out


def submit_latency(torch, tag: str, g, want, backends) -> dict:
    """``Session.submit``'s latency for one auto-rule query on a new graph
    object over ``g``'s arrays (the planner's lift of it and its one
    readback: the bucket, the upper-triangular test and the imbalance
    statistics): alone (median of 5 after one), and
    for each submit made, one every millisecond, by this thread while
    another thread solves ``g``'s batch on a warm session pinned to each
    of ``backends``; only the submits that start inside that solve's
    ``dispatch`` span are the latency under a dispatch in flight (the
    fused peel reads back once a level, the unfused one is one graph
    replay).  Every answer must equal ``want``."""
    import threading

    from repro_torch.api import Session, TrussQuery

    from repro_torch.graphs import CSRGraph

    probe = Session(max_batch=8, device="cuda")  # its queue is never served

    def submit():
        # A graph object of its own for each query, so that no pending
        # query's lift of it is reused: the latency of a graph's first plan.
        fresh = CSRGraph(g.n, g.rowptr, g.colidx, name=g.name, validate=False)
        t0 = time.perf_counter()
        probe.submit(TrussQuery.kmax(fresh))
        return t0, (time.perf_counter() - t0) * 1e3

    def check(results, what):
        for name, a, b in zip(QUERIES, results, want):
            if not same_result(name, a, b):
                raise AssertionError(f"{tag} submit latency, {what}: {name} differs")

    submit()
    out = {"alone_ms": sorted(submit()[1] for _ in range(5))[2]}
    log(f"{tag} submit latency (auto rule): alone {out['alone_ms']:.2f} ms (median of 5)")
    for backend in backends:
        solver = Session(max_batch=8, device="cuda", backend=backend, trace=True)
        check(solver.solve(rmat15_queries(g)), f"{backend} first solve")
        solver.obs.tracer.clear()
        box = {}

        def solve():
            try:
                box["results"] = solver.solve(rmat15_queries(g))
            except BaseException as e:  # re-raised on this thread
                box["error"] = e

        samples = []
        th = threading.Thread(target=solve)
        th.start()
        while th.is_alive():
            samples.append(submit())
            time.sleep(1e-3)
        th.join()
        if "error" in box:
            raise box["error"]
        check(box["results"], f"{backend} concurrent solve")
        (span,) = [e for e in solver.obs.tracer.events()
                   if e["ph"] == "X" and e["name"] == "dispatch"]
        lo, hi = span["ts"] / 1e6, (span["ts"] + span["dur"]) / 1e6
        during = sorted(ms for t0, ms in samples if lo <= t0 < hi)
        out[backend] = {"dispatch_ms": span["dur"] / 1e3, "during_ms": during}
        log(f"{tag} submit latency while another thread's {backend} solve is in its "
            f"{span['dur'] / 1e3:.2f} ms dispatch: {len(during)} of {len(samples)} submits "
            f"started inside it: " + (f"median {during[len(during) // 2]:.2f} ms, max "
                                      f"{during[-1]:.2f} ms" if during else "none")
            + "; the solves' answers as expected")
        del solver
    return out


def prep_only(torch, smi, src: Path) -> int:
    """The graph preparation alone: phase 12 (c)'s and phase 13's packs,
    span splits and submit latencies, with the ``repro_torch`` that
    ``--src`` names, for comparing two trees in one session.  Prints one
    ``prep`` JSON line."""
    from repro_torch.api import bucket_for
    from repro_torch.configs import LARGE_GRAPHS

    out = {"src": str(src)}
    for name, backend in (("rmat-15", "fine/fused/aligned"), ("road-512", "fine/pallas/aligned")):
        g = next(b for b in LARGE_GRAPHS if b.name == name).build()
        out[name] = check_pack(torch, f"prep {name}", [g, g, g], bucket_for(g, chunk=256))
        _, futs, _ = run_session(torch, g, max_batch=8)
        want = [f.result() for f in futs]
        out[name].update(span_split(torch, f"prep {name}", g, want, backend, LaunchCounts(),
                                    futs[0].stats.dispatch_trips))
        out[name]["submit"] = submit_latency(torch, f"prep {name}", g, want, SUBMIT_UNDER[name])
        out[name]["split"] = stage_split(torch, f"prep {name}", g)
        del futs
    log(smi)
    log("prep " + json.dumps(out))
    return 0


def phase_road(torch) -> int:
    """Phase 13: ``road-512`` (``configs.LARGE_GRAPHS``), the balanced-graph
    main path: its three-query batch through ``Session(max_batch=8)`` with
    the auto rule, which must plan ``fine/pallas/aligned``; the answers
    against ``trussness_numpy``; ``support_fine_cuda`` launched once per
    trip.  Then the graph peel beside the eager loop's split.  Returns the
    session's launches."""
    import numpy as np

    from repro_torch.api import bucket_for
    from repro_torch.configs import LARGE_GRAPHS
    from repro_torch.core import trussness_numpy
    from repro_torch.kernels import support_fine_cuda

    g = next(b for b in LARGE_GRAPHS if b.name == "road-512").build()
    bucket = bucket_for(g, chunk=256)
    check_pack(torch, "phase13 road-512", [g, g, g], bucket)
    t0 = time.perf_counter()
    want = trussness_numpy(g)
    log(f"phase13 road-512: n={g.n} nnz={g.nnz} bucket={tuple(bucket)}; trussness_numpy "
        f"{time.perf_counter() - t0:.1f}s")
    support_fine_cuda.launches = 0
    caps = CaptureLog()
    session, futs, wall = caps.run(lambda: run_session(torch, g, max_batch=8))
    launches = support_fine_cuda.launches
    st = session.stats()
    backends = {row["backend"] for row in st["planner_backends"]}
    trips = futs[0].stats.dispatch_trips
    dec, kmax, kt = (f.result() for f in futs)
    log(f"phase13 road-512 Session(max_batch=8), auto rule: {wall:.2f}s wall (first dispatch; "
        f"the trip graph's capture {sum(caps.seconds) * 1e3:.1f} ms of host time), backend "
        f"{sorted(backends)}, dispatches {st['device_dispatches']}, total_iters {trips}, "
        f"support_fine_cuda launches {launches}, host syncs "
        f"{executor_of(session, g, 'fine/pallas/aligned').host_syncs}, levels {dec.levels}, "
        f"kmax {dec.kmax}, ktruss(4) edges {kt.edges_remaining}")
    if backends != {"fine/pallas/aligned"} or st["device_dispatches"] != 1 or len(caps.seconds) != 1:
        raise AssertionError(f"phase13: {st['device_dispatches']} dispatches on {backends}, "
                             f"{len(caps.seconds)} captures")
    if launches != trips or trips == 0:
        raise AssertionError(f"phase13: {launches} support launches over {trips} trips")
    if not np.array_equal(dec.trussness, want) or kmax != (int(want.max()) if want.max() >= 3 else 0):
        raise AssertionError("phase13: decompose/kmax != trussness_numpy")
    check_rmat15_results(g, futs)
    log(f"phase13 {warm_repeat(torch, session, g, futs, 'phase13')}")
    want = [f.result() for f in futs]
    del session, futs, dec, kt
    # The span split's launches are checked there, and are not the main path's.
    span_split(torch, "phase13 road-512", g, want, "fine/pallas/aligned", LaunchCounts(), trips)
    submit_latency(torch, "phase13 road-512", g, want, SUBMIT_UNDER["road-512"])
    phase_peel_split(torch, g, bucket, "phase13", trips)
    return launches


def phase_contig(torch, rmat15, rmat15_want) -> int:
    """Phase 14: the contig layout on the card. rmat-15's and road-512's
    three-query batches through ``Session(max_batch=8,
    backend="fine/pallas/contig")``: one dispatch, no retry or fallback,
    ``support_fine_cuda`` launched once a trip, every answer bit for bit
    the aligned path's (rmat-15's: ``rmat15_want``; road-512's: a
    ``fine/pallas/aligned`` session's, run first); then a warm repeat that
    replays the trip graph. Returns the support launches of the two first
    dispatches."""
    from repro_torch.configs import LARGE_GRAPHS
    from repro_torch.kernels import support_fine_cuda

    road = next(b for b in LARGE_GRAPHS if b.name == "road-512").build()
    _, road_futs, _ = run_session(torch, road, max_batch=8, backend="fine/pallas/aligned")
    total = 0
    for name, g, want in (("rmat-15", rmat15, rmat15_want),
                          ("road-512", road, [f.result() for f in road_futs])):
        support_fine_cuda.launches = 0
        session, futs, wall = run_session(torch, g, max_batch=8, backend="fine/pallas/contig")
        launches = support_fine_cuda.launches
        st = session.stats()
        trips = futs[0].stats.dispatch_trips
        if (st["device_dispatches"] != 1 or st["retries"] or st["backend_fallbacks"]
                or launches != trips or trips == 0):
            raise AssertionError(
                f"phase14 {name} contig: {st['device_dispatches']} dispatches, {st['retries']} "
                f"retries, {st['backend_fallbacks']} fallbacks, {launches} support launches "
                f"over {trips} trips")
        for query, f, w in zip(QUERIES, futs, want):
            if not same_result(query, f.result(), w):
                raise AssertionError(f"phase14 {name} contig: {query} != the aligned path's")
        log(f"phase14 {name} Session(max_batch=8, backend='fine/pallas/contig'): {wall:.2f}s wall "
            f"(first dispatch), total_iters {trips}, support_fine_cuda launches {launches}; "
            "every answer == the aligned path's")
        log(f"phase14 {name} contig {warm_repeat(torch, session, g, futs, f'phase14 {name}')}")
        total += launches
    return total


def phase_fused_main(torch, g, pallas_futs, pallas_wall):
    from repro_torch.kernels import support_fine_cuda
    from repro_torch.kernels.peel_fused import fused_level_cuda

    fused_level_cuda.launches = 0
    support_fine_cuda.launches = 0
    session, futs, wall = run_session(torch, g)
    launches, other = fused_level_cuda.launches, support_fine_cuda.launches
    st = session.stats()
    backends = {row["backend"] for row in st["planner_backends"]}
    level_steps = int(session.obs.metrics.value("peel_fused_levels"))
    dec, _, kt = (f.result() for f in futs)
    log(
        f"phase5 rmat-15 auto rule: backend {sorted(backends)}, {wall:.2f}s wall "
        f"(fine/pallas/aligned: {pallas_wall:.2f}s), dispatches {st['device_dispatches']}, "
        f"level steps {level_steps}, launches {launches}, host syncs "
        f"{executor_of(session, g, 'fine/fused/aligned').host_syncs}, "
        f"total_iters {futs[0].stats.dispatch_trips}, "
        f"levels {dec.levels}, kmax {dec.kmax}, ktruss(4) edges {kt.edges_remaining}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    if backends != {"fine/fused/aligned"}:
        raise AssertionError(f"planner chose {backends}, expected fine/fused/aligned")
    if st["device_dispatches"] != 1:
        raise AssertionError(f"{st['device_dispatches']} dispatches for one bucket")
    if launches != level_steps or launches == 0 or other:
        raise AssertionError(
            f"fused kernel launched {launches} times over {level_steps} level steps "
            f"(support kernel {other} times)"
        )
    check_rmat15_results(g, futs)
    for name, f, pf in zip(QUERIES, futs, pallas_futs):
        same = (f.stats.rounds, f.stats.iterations) == (pf.stats.rounds, pf.stats.iterations)
        if not (same and same_result(name, f.result(), pf.result())):
            raise AssertionError(f"{name}: fused and pallas results differ")
    log("phase5 fused results == fine/pallas/aligned results for decompose, kmax, ktruss(4)")
    return launches, futs, wall


def fused_trip_alive_sets(p, st0, frozen, ftruss, trips: int):
    """The effective alive set each of a level's ``trips`` inner trips
    intersects over, replayed with ``support_fine_cuda`` (support, then
    ``alive &= s >= cur_k - 2``), and the alive lanes per slot after the
    last trip."""
    import torch

    from repro_torch.kernels import support_fine_cuda

    slot_nnz = p.nnz_pad // st0.cur_k.numel()
    k_lane = st0.cur_k.repeat_interleave(slot_nnz)
    flive = frozen & (ftruss >= k_lane)
    alive, sets = st0.alive, []
    for _ in range(trips):
        sets.append(alive | flive)
        alive = alive & (support_fine_cuda(p, sets[-1]) >= k_lane - 2)
    return sets, alive.view(-1, slot_nnz).sum(dim=1, dtype=torch.int32)


def fused_bound(p, inputs, outputs, trip_sets) -> tuple[float, str, float, float]:
    """Least time for one fused level launch on these inputs.  Bytes: each
    input (the problem, the state, the frozen lanes) read once and each
    output written once, whatever the kernel reads again trip after trip.
    Operations: ``support_steps`` summed over the alive set of every inner
    trip this level took."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    ops = sum(support_steps(p, alive) for alive in trip_sets)
    return (*roofline(nbytes, ops), nbytes, ops)


def phase_fused_kernel(torch, g, bucket) -> dict:
    import statistics

    from repro_torch.exec.peel import PeelExecutor, init_peel_state
    from repro_torch.kernels.autotune import FusedConfig, candidate_configs
    from repro_torch.kernels.peel_fused import (
        NUM_STAMPS,
        SPLIT_WAYS,
        fused_level_cuda,
        fused_level_torch,
    )

    p = main_path_problem(g, bucket, slots=8)
    dev = p.device
    slot_ids, k0, single = main_path_slots(torch, bucket)
    frozen = torch.zeros(p.nnz_pad, dtype=torch.bool, device=dev)
    ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32, device=dev)
    st0 = init_peel_state(p, slot_ids, k0, single, p.colidx != 0, frozen, ftruss)
    cfg = FusedConfig().clamp(bucket.nnz_pad)  # the planner's pick without a store

    def kernel(st, stamps=None):
        return fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block,
                                schedule=cfg.schedule, stamps=stamps)

    trip_log = torch.full((2 * 64,), -1, dtype=torch.int32, device=dev)
    got = fused_level_cuda(p, st0, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule,
                           trip_log=trip_log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = fused_level_torch(p, st0, frozen, ftruss, single, window=bucket.window, block=cfg.block)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = 0
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"fused level field {f}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    trips = int(got.total_iters) - int(st0.total_iters)
    log(f"phase6 first level: {trips} inner trips, max_abs_err {err} over all 10 fields")
    if err:
        raise AssertionError("fused_level_cuda disagrees with fused_level_torch on the first level")
    work = [tuple(r) for r in trip_log.view(-1, 2)[: min(trips, 64)].tolist()]
    live0 = int((st0.alive & ~st0.done.repeat_interleave(bucket.nnz_pad)).sum())
    if sum(work[0]) != live0:
        raise AssertionError(f"first worklist {work[0]} != the {live0} alive lanes of live slots")
    log(f"phase6 first level worklist per trip (unsplit + split lanes): "
        f"{', '.join(f'{a}+{b}' for a, b in work)}; split work items per trip "
        f"{', '.join(str(b * SPLIT_WAYS) for _, b in work)} ({SPLIT_WAYS} per split lane)")
    ms = cuda_ms(lambda: kernel(st0), reps=5)
    trip_sets, left = fused_trip_alive_sets(p, st0, frozen, ftruss, trips)
    if not torch.equal(torch.where(st0.done, got.edges_alive, left), got.edges_alive):
        raise AssertionError("the replayed inner trips do not end at the kernel's alive set")
    inputs = (*(getattr(p, f) for f in ("colidx", "edge_row", "u2d", "urowptr", "udeg", "ucolidx")),
              *st0, frozen, ftruss, single)
    bound_ms, bound_by, nbytes, ops = fused_bound(p, inputs, got, trip_sets)
    log(
        f"phase6 fused_level_cuda first level: {ms:.3f} ms/launch; plain {plain_ms:.1f} ms; "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB read once and written "
        f"once; {ops / 1e6:.1f} M steps over the {trips} trips' alive sets); "
        f"block {cfg.block}, schedule {cfg.schedule}"
    )

    # Each level launch of the whole peel, timed by CUDA events; the
    # kernel's own clock (CTA 0's %globaltimer) splits each launch into
    # its phases.
    phases = ("row compaction", "first worklist", "inner trips", "bookkeeping", "prune-ahead")
    st, level_ms, split = st0, [], [0.0] * len(phases)
    stamps = torch.zeros(NUM_STAMPS, dtype=torch.int64, device=dev)
    while not bool(st.done.all()):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st = kernel(st, stamps)
        end.record()
        torch.cuda.synchronize()
        level_ms.append(start.elapsed_time(end))
        t = stamps.tolist()
        split = [ms_ + (t[i + 1] - t[i]) / 1e6 for i, ms_ in enumerate(split)]
    log(
        f"phase6 whole peel by level launches: {len(level_ms)} launches, median "
        f"{statistics.median(level_ms):.3f} ms, max {max(level_ms):.3f} ms, sum {sum(level_ms):.1f} ms, "
        f"total_iters {int(st.total_iters)}"
    )
    log("phase6 the launches' phases, summed (kernel clock): "
        + ", ".join(f"{name} {ms_:.1f} ms" for name, ms_ in zip(phases, split)))

    # Every autotune candidate: the same state, and its whole-peel time
    # beside the unfused kernel path's on the same batch (pallas first and
    # last, candidates between).
    kw = dict(slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())

    def timed(exe):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.peel(p, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pallas = PeelExecutor(mode="owner", backend="pallas", window=bucket.window, chunk=256)
    st_p, pallas_s = timed(pallas)
    first = None
    for c in candidate_configs(bucket.nnz_pad):
        st_f, fused_s = timed(PeelExecutor(backend="fused", window=bucket.window, chunk=256, fused_config=c))
        for f in st_f._fields:
            if f != "total_iters" and not torch.equal(getattr(st_f, f), getattr(st_p, f)):
                raise AssertionError(f"candidate {c}: field {f} differs from fine/pallas/aligned")
        if first is not None and not all(torch.equal(getattr(st_f, f), getattr(first, f)) for f in st_f._fields):
            raise AssertionError(f"candidate {c}: state differs from the first candidate's")
        first = first if first is not None else st_f
        log(f"phase6 candidate block={c.block} schedule={c.schedule}: whole peel {fused_s * 1e3:.1f} ms, "
            f"total_iters {int(st_f.total_iters)}, state == pallas state")
    _, pallas_s2 = timed(pallas)
    log(f"phase6 fine/pallas/aligned whole peel: {pallas_s * 1e3:.1f} ms, {pallas_s2 * 1e3:.1f} ms; "
        f"total_iters {int(st_p.total_iters)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def phase_paths(torch) -> None:
    from repro_torch.api import Session, TrussQuery, bucket_for
    from repro_torch.configs import BENCH_GRAPHS
    from repro_torch.core import trussness_numpy

    graphs = [b.build() for b in BENCH_GRAPHS]
    # The torch-ops backend gathers (E, window) per trip: on the skewed
    # buckets (windows 512 and 1024) it took most of the run's time, so it
    # runs on the narrow-window graphs only.
    narrow = [g for g in graphs if bucket_for(g, chunk=256).window <= XLA_MAX_WINDOW]
    out = {}
    for backend, members in (("fine/fused/aligned", graphs), ("fine/pallas/aligned", graphs),
                             ("fine/xla/aligned", narrow)):
        session = Session(max_batch=8, device="cuda", backend=backend)
        t0 = time.perf_counter()
        results = session.solve([TrussQuery.decompose(g) for g in members])
        out[backend] = dict(zip((g.name for g in members), results))
        torch.cuda.synchronize()
        log(f"phase4 {backend}: {time.perf_counter() - t0:.2f}s over {len(members)} graphs, "
            f"dispatches {session.device_dispatches}")
    ref = out["fine/pallas/aligned"]
    for backend in ("fine/fused/aligned", "fine/xla/aligned"):
        for name, a in out[backend].items():
            b = ref[name]
            if not (a.trussness == b.trussness).all() or (a.kmax, a.levels) != (b.kmax, b.levels):
                raise AssertionError(f"{name}: {backend} and fine/pallas/aligned disagree")
    for g in graphs:
        a = ref[g.name]
        agree = "all three" if g.name in out["fine/xla/aligned"] else "fused and pallas"
        log(f"phase4 {g.name}: n={g.n} nnz={g.nnz} kmax={a.kmax} levels={a.levels} agree on {agree}")
        if g.name in ("er-4k", "clustered-32x40"):
            if not (a.trussness == trussness_numpy(g)).all():
                raise AssertionError(f"{g.name}: trussness != numpy oracle")
            log(f"phase4 {g.name}: equals trussness_numpy")
    sweep_buckets(graphs, Session(max_batch=8, device="cuda").planner)


def sweep_buckets(graphs, planner) -> None:
    """Each graph's fused peel for every autotune candidate in its own
    bucket, as the planner packs it, timed by ``autotune_fused`` (best of
    3, warm); nothing is stored."""
    from repro_torch.api import bucket_for
    from repro_torch.kernels.autotune import autotune_fused, candidate_configs, get_store

    if get_store() is not None:
        raise AssertionError("an autotune store is installed; the sweep would write to it")
    totals: dict[tuple, float] = {}
    for g in graphs:
        bucket = bucket_for(g, chunk=planner.chunk)
        cands = candidate_configs(bucket.nnz_pad)
        winner, rows = autotune_fused(
            bucket, planner.max_batch, graphs=[g], chunk=planner.chunk,
            candidates=cands, repeats=3, device="cuda",
        )
        row = " ".join(f"{r['config']['block']}/{r['config']['schedule']}={r['best_s'] * 1e3:.2f}"
                       for r in rows)
        log(f"phase4 sweep {g.name} {tuple(bucket)}: {row} ms; best {winner.block}/{winner.schedule}")
        for c, r in zip(cands, rows):
            totals[c.signature()] = totals.get(c.signature(), 0.0) + r["best_s"]
    row = " ".join(f"{b}/{sch}={t * 1e3:.2f}" for (b, sch), t in sorted(totals.items(), key=lambda kv: kv[1]))
    log(f"phase4 sweep sum over the {len(graphs)} buckets: {row} ms")


def dense_adjacency(torch, g, vp: int):
    """rmat-15's dense symmetric 0/1 adjacency in the reference's 1-based
    layout, zero-padded to (vp, vp) int8, built on the card by scattering
    the CSR's (row, col) and (col, row); and the edges' rows and columns."""
    rows = torch.from_numpy(g.row_of_edge()).cuda().long()
    cols = torch.from_numpy(g.colidx).cuda().long()
    u = torch.zeros((vp, vp), dtype=torch.int8, device="cuda")
    u[rows, cols] = 1
    u[cols, rows] = 1
    return u, rows, cols


def peak_gib(torch, fn):
    """``fn()``'s result, the device memory peak during the call and what
    was allocated before it (GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30, before


def phase_dense(torch, g) -> dict:
    import numpy as np

    from repro_torch.core import prepare_fine
    from repro_torch.kernels import ops, support_fine_cuda
    from repro_torch.kernels.support_dense import (
        TILE,
        support_dense_cuda,
        support_dense_torch,
        transpose_cuda,
    )
    from repro_torch.examples import median_ms

    cuda = torch.device("cuda")  # every timed call below has already run once
    n1 = g.n + 1
    vp = -(-n1 // TILE) * TILE
    up, rows, cols = dense_adjacency(torch, g, vp)
    held = torch.cuda.memory_allocated() / 2**30

    # The slice's path: the public entry point at full width.
    support_dense_cuda.launches = 0
    s, peak_ops, _ = peak_gib(torch, lambda: ops.support_dense(up[:n1, :n1]))
    launches = support_dense_cuda.launches
    p = prepare_fine(g, chunk=256, device="cuda")
    sf = support_fine_cuda(p, p.colidx != 0)[: g.nnz].float()
    torch.cuda.synchronize()
    if s.shape != (n1, n1) or s.dtype != torch.float32 or launches != 1:
        raise AssertionError(f"ops.support_dense: {tuple(s.shape)} {s.dtype}, {launches} launches")
    if not (torch.equal(s[rows, cols], sf) and torch.equal(s[cols, rows], sf)):
        raise AssertionError("S at the edges != support_fine_cuda with every lane alive")
    if float(s.min()) < 0 or float(s.double().sum()) != 2 * float(sf.double().sum()):
        raise AssertionError("S is not zero off the edges")
    log(f"phase7 ops.support_dense rmat-15: V={n1} padded to {vp}, {launches} launch; "
        f"S == support_fine_cuda at all {g.nnz} edges (both orientations), zero elsewhere; "
        f"peak {peak_ops:.2f} GiB ({held:.2f} GiB held before)")
    del s, p, sf

    # Kernel vs its plain version, bit for bit, on the padded matrix and
    # on an asymmetric random 0/1 matrix.
    got, peak_k, before_k = peak_gib(torch, lambda: support_dense_cuda(up))
    want, peak_p, before_p = peak_gib(torch, lambda: support_dense_torch(up))
    err_full, same = float((got - want).abs().max()), torch.equal(got, want)
    del want
    rng = np.random.default_rng(4096)
    ua = torch.from_numpy((rng.random((4096, 4096)) < 0.1).astype(np.int8)).cuda()
    if torch.equal(ua, ua.t()):
        raise AssertionError("the asymmetric input came out symmetric")
    ga, wa = support_dense_cuda(ua), support_dense_torch(ua)
    err_asym = float((ga - wa).abs().max())
    u_gib = vp * vp / 2**30
    log(f"phase7 support_dense_cuda vs support_dense_torch: V={vp} max_abs_err {err_full}, "
        f"asymmetric V=4096 max_abs_err {err_asym}; call footprint (peak above what was held "
        f"before, plus the {u_gib:.2f} GiB of U read): kernel {peak_k - before_k + u_gib:.2f} GiB, "
        f"plain {peak_p - before_p + u_gib:.2f} GiB")
    if not same or not torch.equal(ga, wa):
        raise AssertionError("support_dense_cuda disagrees with support_dense_torch")
    err = max(err_full, err_asym)
    del ga, wa, ua

    ms = median_ms(lambda: support_dense_cuda(up), cuda, 7)
    plain_ms = median_ms(lambda: support_dense_torch(up), cuda, 3)

    # The yardstick: cuBLAS's int8 product, then the mask.  With the second
    # operand column-major (its layout for int8) it is several times faster
    # than with both row-major, so library_ms is that form; both are timed.
    def library():
        return torch._int_mm(up, up.t().contiguous().t()) * up

    def library_row_major():
        return torch._int_mm(up, up) * up

    for fn in (library, library_row_major):
        lib = fn()
        if not torch.equal(lib.float(), got):
            raise AssertionError(f"the {fn.__name__} yardstick disagrees with the kernel")
        del lib
    del got
    library_ms = median_ms(library, cuda, 5)
    row_major_ms = median_ms(library_row_major, cuda, 5)
    if not torch.equal(transpose_cuda(up), up.t().contiguous()):
        raise AssertionError("the library's transpose disagrees with u.t().contiguous()")
    transpose_ms = median_ms(lambda: transpose_cuda(up), cuda, 7)
    torch_transpose_ms = median_ms(lambda: up.t().contiguous(), cuda, 3)
    nbytes = 6.0 * vp * vp  # U and UT read once (1 byte each), S written once (4 bytes)
    ops_count = 2.0 * vp**3
    bound_ms, bound_by = roofline(nbytes, ops_count, INT8_TENSOR_OPS_PER_S)
    log(f"phase7 support_dense_cuda: {ms:.3f} ms/launch (median of 7); plain {plain_ms:.1f} ms; "
        f"torch._int_mm + mask {library_ms:.3f} ms (both operands row-major: "
        f"{row_major_ms:.3f} ms); bound {bound_ms:.3f} ms by {bound_by} "
        f"({ops_count / 1e12:.1f} T int8 ops, {nbytes / 1e9:.2f} GB); "
        f"{ops_count / ms / 1e9:.1f} TOPS achieved, {bound_ms / ms:.1%} of the bound")
    log(f"phase7 making U^T: {transpose_ms:.3f} ms by the library's transpose kernel, "
        f"{transpose_ms / ms:.1%} of the call; torch's u.t().contiguous() {torch_transpose_ms:.3f} ms")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


ENGINE_COMBOS = (
    ("coarse", "eager", "xla", False),
    ("fine", "eager", "xla", False),
    ("fine", "owner", "xla", False),
    ("fine", "owner", "pallas", False),
    ("fine", "eager", "xla", True),
)


def phase_engine(torch, g, pallas_futs, smi) -> None:
    from repro_torch.configs import BENCH_GRAPHS
    from repro_torch.core import KTrussEngine
    from repro_torch.examples.quickstart import grid
    from repro_torch.kernels import support_fine_cuda

    dec, kmax, kt = (f.result() for f in pallas_futs)
    t0 = time.perf_counter()
    support_fine_cuda.launches = 0
    before = support_fine_cuda.launches
    eng = KTrussEngine(g, granularity="fine", mode="owner", backend="pallas", device="cuda")
    r4 = eng.ktruss(4)
    e_kmax = eng.kmax()
    e_dec = eng.decompose()
    l_kmax, levels = eng.peel_levels()
    r_top = eng.ktruss(l_kmax)
    torch.cuda.synchronize()
    after = support_fine_cuda.launches
    log(f"phase8 KTrussEngine rmat-15 fine/owner/pallas: {time.perf_counter() - t0:.2f}s; "
        f"support_fine_cuda.launches {before} -> {after}; ktruss(4) {r4.edges_remaining} edges in "
        f"{r4.iterations} trips (phase 3: {kt.edges_remaining}); kmax {e_kmax} (phase 3: {kmax}); "
        f"peel_levels kmax {l_kmax} over {len(levels)} levels; window {eng.window}")
    if after <= before:
        raise AssertionError("KTrussEngine(backend='pallas') did not launch support_fine_cuda")
    if not (r4.edges_remaining == kt.edges_remaining and (r4.alive == kt.alive).all()
            and (r4.support == kt.support).all()):
        raise AssertionError("engine ktruss(4) != phase 3's ktruss(4)")
    if e_kmax != kmax or l_kmax != dec.kmax:
        raise AssertionError(f"engine kmax {e_kmax} / peel_levels {l_kmax} != phase 3's {kmax}")
    if not ((e_dec.trussness == dec.trussness).all() and e_dec.kmax == dec.kmax):
        raise AssertionError("engine decompose() != phase 3's trussness")
    if not (levels[-1].k == l_kmax and (levels[-1].alive == r_top.alive).all()):
        raise AssertionError("the last peel level's alive != ktruss(kmax)")
    log("phase8 engine == phase 3 on ktruss(4), kmax, trussness; last level == ktruss(kmax)")

    # The quickstart's grid: the paper's Table I in miniature.
    gg = next(b for b in BENCH_GRAPHS if b.name == ENGINE_GRID_GRAPH).build()
    t0 = time.perf_counter()
    rows = grid(gg, ENGINE_COMBOS, device="cuda")
    base = rows[0].result
    for row in rows:
        res = row.result
        log(f"phase8 {ENGINE_GRID_GRAPH} {row.tag:28s} support {row.ms:9.3f} ms "
            f"({gg.nnz / row.ms / 1e3:8.2f} ME/s); 4-truss edges {res.edges_remaining}, "
            f"{res.iterations} trips")
        if not ((res.alive == base.alive).all() and (res.support == base.support).all()):
            raise AssertionError(f"{row.tag} disagrees on ktruss(4)")
    log(f"phase8 grid on {ENGINE_GRID_GRAPH} (n={gg.n}, nnz={gg.nnz}): all agree on ktruss(4); "
        f"{time.perf_counter() - t0:.2f}s; card {smi}")


STREAM_WIDTHS = (1, 16, 256)  # the reference stream_bench's batch widths
STREAM_BATCHES = 2  # per width: the first, then a warm one
# The update's top-level spans, in order (peel-level spans nest in dispatch).
STREAM_SPANS = ("stream.delta", "stream.triangles", "stream.frontier", "plan", "pack", "compile",
                "dispatch", "device-wait", "unpack")
# Updates whose lowered inputs hold the frozen-lane kernels: the first
# width-256 batch, and the first width-1 batch (one insert: a small
# frontier, most lanes frozen and live).
HELD_UPDATES = ((256, 0), (1, 0))


def balanced_batches(rng, g, width: int, count: int):
    """``count`` balanced, conflict-free batches of ``width`` updates against
    ``g`` (the reference ``stream_bench``'s rule): half inserts and half
    deletes, width 1 alternating insert and delete; inserts are fresh
    pairs, deletes existing edges not deleted by an earlier batch."""
    from repro_torch.stream import EdgeBatch

    existing = set(map(tuple, (g.edge_list() - 1).tolist()))
    deletable = sorted(existing)
    batches, flip = [], False
    for _ in range(count):
        n_del = width // 2 if width > 1 else (1 if flip else 0)
        n_ins = width - n_del
        flip = not flip
        ins = []
        while len(ins) < n_ins:
            a, b = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
            key = (min(a, b), max(a, b))
            if a != b and key not in existing:
                ins.append(key)
                existing.add(key)
        dels = [deletable[i] for i in sorted(rng.permutation(len(deletable))[:n_del], reverse=True)]
        for d in dels:
            deletable.remove(d)
            existing.discard(d)
        batches.append(EdgeBatch.of(ins, dels))
    return batches


class LaunchCounts:
    """Launches of the two peel kernels made by stream-path calls only:
    each counted call zeroes the kernels' counts just before and reads
    them just after, so checks between calls are not counted."""

    def __init__(self):
        self.fused = self.support = 0

    def run(self, fn):
        from repro_torch.kernels import support_fine_cuda
        from repro_torch.kernels.peel_fused import fused_level_cuda

        fused_level_cuda.launches = support_fine_cuda.launches = 0
        out = fn()
        self.fused += fused_level_cuda.launches
        self.support += support_fine_cuda.launches
        return out


def scratch_trussness(scratch, graphs):
    """From-scratch decompose of each graph through ``scratch`` (a session
    pinned to ``fine/pallas/aligned``), one dispatch."""
    from repro_torch.api import TrussQuery

    return [r.trussness for r in scratch.solve([TrussQuery.decompose(x) for x in graphs])]


def independent_frontier(torch, g_old, t_old, batch, *, vs_cpu: str | None = None):
    """The update's delta, its frontier by a full enumeration of the union
    graph on the card (not the session's cache), and the carried
    trussness on the new graph's edges.  With ``vs_cpu`` (a tag for the
    error), the delta and the frontier are held field by field against
    ``device="cpu"``'s from the same committed state (the CPU's closure is
    given the card's union triangles, whose order phase 9 checks)."""
    import numpy as np

    from repro_torch.stream import apply_batch, compute_frontier

    delta = apply_batch(g_old, batch)
    fr = compute_frontier(t_old, delta, device="cuda")
    carry = np.full(delta.new_graph.nnz, 2, np.int32)
    shared = delta.new2old >= 0
    carry[shared] = t_old[delta.new2old[shared]]
    if vs_cpu is not None:
        from repro_torch.stream.frontier import edge_triangles, union_graph

        d_cpu = apply_batch(g_old, batch, device="cpu")
        union = union_graph(delta)
        tri_keys = union[1][edge_triangles(union[0], device="cuda")].cpu()
        f_cpu = compute_frontier(t_old, d_cpu, tri_keys=tri_keys, device="cpu")
        pairs = [(f"delta {f}", a, b) for f, a, b in zip(delta.tensors._fields, delta.tensors,
                                                          d_cpu.tensors)]
        pairs += [(f"frontier {f}", a, b) for f, a, b in zip(fr.tensors._fields, fr.tensors,
                                                             f_cpu.tensors)]
        for what, a, b in pairs:
            if not (a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b)):
                raise AssertionError(f"{vs_cpu}: the card's {what} differs from device='cpu''s")
        if (fr.rounds, fr.num_triangles, fr.size) != (f_cpu.rounds, f_cpu.num_triangles, f_cpu.size):
            raise AssertionError(f"{vs_cpu}: the card's closure differs from device='cpu''s")
        log(f"{vs_cpu}: the card's delta ({len(pairs) - 3} fields) and frontier (3 fields, "
            f"{fr.rounds} rounds, {fr.num_triangles} triangles) == device='cpu''s")
    return delta, fr, carry


def check_update(res, fr, carry, want, what: str) -> None:
    """An update against from-scratch trussness and its frontier."""
    import numpy as np

    if res.trussness.dtype != np.int32 or not np.array_equal(res.trussness, want):
        raise AssertionError(f"{what}: trussness != the from-scratch fine/pallas/aligned decompose")
    if fr.size != res.frontier_size:
        raise AssertionError(f"{what}: frontier {res.frontier_size} != {fr.size} by a full enumeration")
    outside = int(((res.trussness != carry) & ~fr.frontier).sum())
    if outside:
        raise AssertionError(f"{what}: {outside} edges changed trussness outside the frontier")


class PeelCapture:
    """Records the arguments of one executor's next ``peel`` calls (the
    lowered stream_update's packed problem and frozen lanes)."""

    def __init__(self, exe):
        self.exe, self.calls = exe, []

    def __enter__(self):
        real = self.exe.peel

        def peel(p, **kw):
            self.calls.append(dict(p=p, **{k: v.clone() if hasattr(v, "clone") else v
                                           for k, v in kw.items()}))
            return real(p, **kw)

        self.exe.peel = peel
        return self

    def __exit__(self, *exc):
        del self.exe.peel


def hold_frozen_kernels(torch, held, window: int, key) -> float:
    """``fused_level_cuda``'s first level and ``support_fine_cuda`` on
    ``alive | frozen-live``, on one real stream update's lowered inputs,
    each bit for bit against its plain version; returns the max abs error."""
    import numpy as np

    from repro_torch.core import support_fine_owner
    from repro_torch.exec.peel import init_peel_state
    from repro_torch.kernels import support_fine_cuda
    from repro_torch.kernels.peel_fused import fused_level_cuda, fused_level_torch

    call, exe = held
    p, dev = call["p"], call["p"].device
    k0 = torch.as_tensor(np.asarray(call["k0"], np.int32), device=dev)
    single = torch.as_tensor(np.asarray(call["single_level"], bool), device=dev)
    slot_ids = call["slot_ids"].to(dev, torch.int32)
    alive0, frozen, ftruss = call["alive0"], call["frozen"], call["frozen_truss"]
    st0 = init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss)
    cfg = exe.fused_config
    got = fused_level_cuda(p, st0, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule)
    want = fused_level_torch(p, st0, frozen, ftruss, single, window=window, block=cfg.block)
    err = 0
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"fused_level_cuda field {f} != fused_level_torch on frozen lanes")
        err = max(err, int((a.long() - b.long()).abs().max()) if a.numel() else 0)
    lanes_k = k0[slot_ids.long()]
    eff = alive0 | (frozen & (ftruss >= lanes_k))
    s_got = support_fine_cuda(p, eff)
    s_want = support_fine_owner(p, eff, window=window, chunk=1024)
    if not torch.equal(s_got, s_want):
        raise AssertionError("support_fine_cuda != support_fine_owner on alive | frozen-live")
    err = max(err, int((s_got.long() - s_want.long()).abs().max()))
    log(f"phase9 frozen-lane kernels on the width-{key[0]} batch-{key[1]} update's lowered "
        f"inputs: alive0 {int(alive0.sum())} lanes, frozen {int(frozen.sum())} (live at the first "
        f"level {int((eff & ~alive0).sum())}); fused_level_cuda first level ({int(got.total_iters)} inner "
        f"trips, block {cfg.block}/{cfg.schedule}) == fused_level_torch on all {len(got._fields)} "
        f"fields; support_fine_cuda == support_fine_owner (sum {int(s_got.long().sum())}); "
        f"max_abs_err {err}")
    return err


def span_ms(tracer) -> dict:
    """Summed host durations (ms) of the stream spans recorded since the
    tracer was last cleared."""
    out = dict.fromkeys(STREAM_SPANS, 0.0)
    for ev in tracer.events():
        if ev["name"] in out:
            out[ev["name"]] += ev["dur"] / 1e3
    return out


def stream_widths(torch, g, dec, counts, *, hold: bool):
    """One stream on ``Session(max_batch=8)`` (auto rule) seeded by an empty
    update, then ``STREAM_BATCHES`` balanced batches at each width: each
    update bit for bit a from-scratch decompose, changed only inside its
    frontier, timed, split by span and its bytes copied each way counted;
    the first batch of each width's delta and frontier held against
    ``device="cpu"``'s where the tree's ``apply_batch`` takes a device
    (an older tree's, run through ``--src``, may not).  With ``hold``, the lowered peel inputs of
    ``HELD_UPDATES``.  Returns the stream, the update records and what was
    held."""
    import contextlib
    import inspect

    import numpy as np

    from repro_torch.api import Session
    from repro_torch.stream import ENUM_COUNTS, EdgeBatch, apply_batch

    on_device = "device" in inspect.signature(apply_batch).parameters
    session = Session(max_batch=8, device="cuda", trace=True)
    scratch = Session(max_batch=1, device="cuda", backend="fine/pallas/aligned")
    stream = session.open_stream(g, trussness=dec.trussness)
    tracer = session.obs.tracer
    full0 = ENUM_COUNTS["full"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seed_res = counts.run(lambda: stream.update(EdgeBatch.of()))  # seeds the triangle cache
    seed_ms = (time.perf_counter() - t0) * 1e3
    if seed_res.dispatches or ENUM_COUNTS["full"] != full0 + 1:
        raise AssertionError("the empty seeding update dispatched or did not enumerate once")
    log(f"phase9 stream opened on Session(max_batch=8), auto rule; empty update (the one full "
        f"enumeration + an empty frontier): {seed_ms:.1f} ms, {stream.stats()['cached_triangles']} "
        f"cached triangles, 0 dispatches; spans " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in span_ms(tracer).items()))
    rng = np.random.default_rng(16)
    held = {}  # (width, batch) -> the update's lowered peel arguments and executor
    records = []
    for width in STREAM_WIDTHS:
        for i, batch in enumerate(balanced_batches(rng, stream.graph, width, STREAM_BATCHES)):
            g_old, t_old = stream.graph, stream.trussness
            tag = f"phase9 width {width} batch {i}"
            delta, fr, carry = independent_frontier(
                torch, g_old, t_old, batch, vs_cpu=tag if on_device and i == 0 else None)
            keep = hold and (width, i) in HELD_UPDATES
            exe = executor_of(session, delta.new_graph, "fine/fused/aligned", built=False)
            tracer.clear()
            copies = Copies()
            with PeelCapture(exe) if keep else contextlib.nullcontext() as cap:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = copies.run(torch, lambda b=batch: counts.run(lambda: stream.update(b)))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            spans = span_ms(tracer)
            want = scratch_trussness(scratch, [delta.new_graph])[0]
            check_update(res, fr, carry, want, tag)
            if keep:
                if len(cap.calls) != 1:
                    raise AssertionError(f"the width-{width} update made {len(cap.calls)} peels")
                held[width, i] = (cap.calls[0], exe)
            records.append(dict(width=width, batch=i, wall_ms=wall_ms, spans=spans,
                                h2d_mb=copies.bytes / 1e6, d2h_mb=copies.read_bytes() / 1e6,
                                frontier=res.frontier_size, dispatches=res.dispatches))
            log(f"{tag}: +{res.num_inserts}/-{res.num_deletes}, frontier "
                f"{res.frontier_size} ({res.frontier_frac:.4f} of {res.num_edges}), closure rounds "
                f"{fr.rounds}, union triangles {fr.num_triangles}, dispatches {res.dispatches}; "
                f"update wall {wall_ms:.1f} ms = " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in spans.items())
                + f", outside spans {wall_ms - sum(spans.values()):.1f} ms; "
                f"{copies.bytes / 1e6:.3f} MB to the card in {copies.copies} copies, "
                f"{copies.read_bytes() / 1e6:.3f} MB read back in {len(copies.reads)}; "
                "== from-scratch fine/pallas/aligned")
    cols = ["wall"] + [k for k in STREAM_SPANS if k not in ("compile", "device-wait")]

    def value(r, k):
        return r["wall_ms"] if k == "wall" else r["spans"][k]

    for width in STREAM_WIDTHS:
        first, *warm = [r for r in records if r["width"] == width]
        split = ", ".join(f"{k} {value(first, k):.1f} [" + "/".join(
            f"{value(r, k):.1f}" for r in warm) + "]" for k in cols)
        log(f"phase9 width {width} split (ms), first [warm]: {split}; MB to the card "
            f"{first['h2d_mb']:.3f} [" + "/".join(f"{r['h2d_mb']:.3f}" for r in warm) + "]")
    if stream.metrics.value("stream_enumerations", kind="full") != 1:
        raise AssertionError("the stream enumerated all triangles more than once")
    if counts.fused == 0:
        raise AssertionError("the stream updates never launched fused_level_cuda")
    log(f"phase9 stream: {stream.stats()}; fused_level_cuda launches {counts.fused}")
    return stream, records, held


def stream_coalesced(torch, g, dec, counts) -> dict:
    """Eight streams' updates on one session coalescing into one dispatch;
    then one more width-16 batch a stream, each ``submit_update`` timed
    alone, and one more while another session's ``fine/pallas/aligned``
    solve of the rmat-15 batch replays its trip graph (which holds the
    card: every device stage of a submit waits for it).  Every update
    equal to a from-scratch decompose.  Only the coalesced dispatch's
    launches join ``counts`` (the phase's launches, as before these
    timings); the timed rounds' are printed apart.  Returns the submit
    latencies."""
    import threading

    import numpy as np

    from repro_torch.api import Session

    co = Session(max_batch=8, device="cuda")
    scratch = Session(max_batch=8, device="cuda", backend="fine/pallas/aligned")
    streams = [co.open_stream(g, trussness=dec.trussness) for _ in range(8)]

    def batches(seed):
        return [balanced_batches(np.random.default_rng(seed + i), s.graph, 16, 1)[0]
                for i, s in enumerate(streams)]

    def resolve(pend, what):
        results = [p.result() for p in pend]
        wants = scratch_trussness(scratch, [s.graph for s in streams[: len(pend)]])
        for i, (r, w) in enumerate(zip(results, wants)):
            if not np.array_equal(r.trussness, w):
                raise AssertionError(f"{what}: stream {i} != its from-scratch decompose")
        return results

    before = co.device_dispatches
    t0 = time.perf_counter()
    pend = [s.submit_update(b) for s, b in zip(streams, batches(100))]
    counts.run(co.flush)
    results = resolve(pend, "coalesced")
    co_ms = (time.perf_counter() - t0) * 1e3
    if co.device_dispatches != before + 1:
        raise AssertionError(f"8 stream updates made {co.device_dispatches - before} dispatches")
    log(f"phase9 8 streams on one Session(max_batch=8): submit_update x 8 + flush = 1 dispatch; "
        f"{co_ms:.1f} ms (8 full enumerations included); frontiers "
        f"{[r.frontier_size for r in results]}; each == from-scratch")

    def timed_submits(pairs, keep_going=lambda: True):
        out, pend = [], []
        for s, b in pairs:
            if not keep_going():
                break
            t0 = time.perf_counter()
            pend.append(s.submit_update(b))
            out.append((t0, (time.perf_counter() - t0) * 1e3))
            time.sleep(1e-3)
        return out, pend

    timed = LaunchCounts()
    alone, pend = timed_submits(zip(streams, batches(200)))
    timed.run(co.flush)
    resolve(pend, "alone")
    alone_ms = sorted(ms for _, ms in alone)
    solver = Session(max_batch=8, device="cuda", backend="fine/pallas/aligned", trace=True)
    first = solver.solve(rmat15_queries(g))  # captures the trip graph
    if not np.array_equal(first[0].trussness, dec.trussness):
        raise AssertionError("the replaying session's decompose != phase 5's")
    solver.obs.tracer.clear()
    box = {}

    def solve():
        try:
            box["results"] = solver.solve(rmat15_queries(g))
        except BaseException as e:  # re-raised on this thread
            box["error"] = e

    pairs = list(zip(streams, batches(300)))  # made before the replay starts
    th = threading.Thread(target=solve)
    th.start()
    time.sleep(0.05)  # past the solve's plan and pack (about 15 ms warm), into its replay
    samples, pend = timed_submits(pairs, th.is_alive)
    th.join()
    if "error" in box:
        raise box["error"]
    if not np.array_equal(box["results"][0].trussness, dec.trussness):
        raise AssertionError("the replaying session's second decompose != phase 5's")
    timed.run(co.flush)
    resolve(pend, "under a replay")
    (span,) = [e for e in solver.obs.tracer.events() if e["ph"] == "X" and e["name"] == "dispatch"]
    lo, hi = span["ts"] / 1e6, (span["ts"] + span["dur"]) / 1e6
    during = sorted(ms for t0, ms in samples if lo <= t0 < hi)
    log(f"phase9 submit_update latency (width 16, warm streams): alone median "
        f"{alone_ms[len(alone_ms) // 2]:.2f} ms, max {alone_ms[-1]:.2f} ms (8 submits); while "
        f"another session's fine/pallas/aligned replay is in its {span['dur'] / 1e3:.2f} ms "
        f"dispatch: {len(during)} of {len(samples)} submits started inside it: "
        + (", ".join(f"{ms:.2f}" for ms in during) + " ms" if during else "none")
        + f"; every update == from-scratch; these rounds' launches (not the phase's): "
        f"fused_level_cuda {timed.fused}, support_fine_cuda {timed.support}")
    return {"alone_ms": alone_ms, "replay_ms": span["dur"] / 1e3, "during_ms": during}


def phase_stream(torch, g, dec) -> dict:
    """Streaming K-truss on the card at full width (rmat-15); returns the
    stream path's launches of the two peel kernels."""
    import statistics
    import tempfile

    import numpy as np

    from repro_torch.api import bucket_for
    from repro_torch.core import prepare_fine
    from repro_torch.kernels import support_fine_cuda
    from repro_torch.resilience import restore_session
    from repro_torch.service import TrussService
    from repro_torch.stream import ENUM_COUNTS, edge_triangles

    counts = LaunchCounts()
    t_phase = time.perf_counter()

    # 1. The one full enumeration, on the card; its count against the
    # support kernel and its order against the CPU's.
    tri_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tri = edge_triangles(g, device="cuda")
        torch.cuda.synchronize()
        tri_ms.append((time.perf_counter() - t0) * 1e3)
    p1 = prepare_fine(g, chunk=256, device="cuda")
    sup = support_fine_cuda(p1, p1.colidx != 0)
    total = int(sup[p1.colidx != 0].long().sum())
    if tri.device.type != "cuda" or 3 * tri.shape[0] != total:
        raise AssertionError(f"3 x {tri.shape[0]} triangles != {total}, the support kernel's sum")
    cpu_tri = edge_triangles(g, device="cpu")
    if not torch.equal(tri.cpu(), cpu_tri):
        raise AssertionError("edge_triangles on the card != on the CPU (values or order)")
    log(f"phase9 edge_triangles rmat-15 on the card: {tri.shape[0]} triangles, 3T = {total} = "
        f"sum of support_fine_cuda over every real lane; == the CPU's, in order; "
        f"median {statistics.median(tri_ms):.1f} ms of 3 ({', '.join(f'{t:.1f}' for t in tri_ms)})")
    del p1, sup, tri, cpu_tri

    # 2. One stream on the auto rule, balanced batches by width.
    stream, _, held = stream_widths(torch, g, dec, counts, hold=True)

    # 3. The frozen-lane kernels on real updates' lowered inputs.
    window = bucket_for(stream.graph, chunk=256).window
    err = max(hold_frozen_kernels(torch, held[key], window, key) for key in HELD_UPDATES)
    del held

    # 4. Eight streams' updates coalesce into one dispatch; submit_update
    # alone and under another session's trip-graph replay.
    stream_coalesced(torch, g, dec, counts)

    # 5. Checkpoint, restore on the card, continue; the legacy adapter.
    with tempfile.TemporaryDirectory() as tmp:
        path = stream.checkpoint(f"{tmp}/stream.npz")
        restored = restore_session(path, max_batch=8)
    if restored.device.type != "cuda" or restored._tri_cache.tri_keys.device.type != "cuda":
        raise AssertionError("the restored stream is not on the card")
    b1, b2 = balanced_batches(np.random.default_rng(7), stream.graph, 16, 2)
    full0 = ENUM_COUNTS["full"]
    ra = counts.run(lambda: stream.update(b1))
    rb = counts.run(lambda: restored.update(b1))
    if not np.array_equal(ra.trussness, rb.trussness) or ENUM_COUNTS["full"] != full0:
        raise AssertionError("the restored stream diverged or re-enumerated")
    g1, t1 = stream.graph, stream.trussness
    delta, fr, carry = independent_frontier(torch, g1, t1, b2)
    r2 = counts.run(lambda: stream.update(b2))
    svc = TrussService(backend="pallas", max_batch=8)
    got = counts.run(lambda: svc.submit_stream(
        delta.new_graph, frontier=fr.frontier,
        frozen_truss=np.where(fr.frontier, 0, carry).astype(np.int32)).result())
    opened = svc.open_stream(g1, trussness=t1)
    got_open = counts.run(lambda: opened.update(b2))
    for name, t in (("submit_stream", got), ("open_stream", got_open.trussness)):
        if not np.array_equal(t, r2.trussness):
            raise AssertionError(f"TrussService(backend='pallas').{name} != the stream's update")
    if counts.support == 0:
        raise AssertionError("the pallas adapter's stream path never launched support_fine_cuda")
    log(f"phase9 checkpoint -> restore_session on the card -> the same batch: identical, no full "
        f"enumeration; TrussService(backend='pallas') submit_stream and open_stream update == the "
        f"stream's (frontier {r2.frontier_size}); support_fine_cuda launches {counts.support}")
    log(f"phase9 stream phase {time.perf_counter() - t_phase:.1f}s; stream-path launches: "
        f"fused_level_cuda {counts.fused}, support_fine_cuda {counts.support}")
    return dict(fused=counts.fused, support=counts.support, max_abs_err=err)


def stream_only(torch, g, smi, src: Path) -> int:
    """Phase 9's stream updates alone (the span split by width, first and
    warm, the bytes copied each way, the card against the CPU where the
    tree supports it) and the coalesced and concurrent submits, with the
    ``repro_torch`` that ``--src`` names, for comparing two trees in one
    session.  Prints one ``stream`` JSON line."""
    from repro_torch.api import Session, TrussQuery

    dec = Session(max_batch=8, device="cuda").solve([TrussQuery.decompose(g)])[0]
    counts = LaunchCounts()
    _, records, _ = stream_widths(torch, g, dec, counts, hold=False)
    submits = stream_coalesced(torch, g, dec, counts)
    log(smi)
    log("stream " + json.dumps({"src": str(src), "updates": records, "submit": submits,
                                "launches": {"fused": counts.fused, "support": counts.support}}))
    return 0


def resilience_counters() -> dict:
    """The process-wide registry's resilience counters (every session
    chains to it)."""
    from repro_torch.obs import get_registry

    counters = get_registry().snapshot()["counters"]
    return {k: v for k, v in counters.items() if k.split("{")[0] in RESILIENCE_KEYS}


def check_phases_clean() -> None:
    """Every session of phases 1-9 chains its metrics to the process-wide
    registry, so zero there means zero in each of them."""
    moved = {k: v for k, v in resilience_counters().items() if v}
    if moved:
        raise AssertionError(f"phases 1-9 moved resilience counters: {moved}")
    log("phases 1-9: retries, backend_fallbacks, faults_injected, queries_quarantined all 0 "
        "over every session (the process-wide registry)")


COOPERATIVE_LAUNCH_TOO_LARGE = 720  # cudaError_t cudaErrorCooperativeLaunchTooLarge


def resilience_case(torch, g, faults, counts, *, poison_kmax: bool = False):
    """The phase-5 batch through a fresh ``Session(max_batch=8)`` (auto rule)
    under ``faults``: the session, its futures, its wall, its launches."""
    from repro_torch.api import Session
    from repro_torch.resilience import parse_faults

    session = Session(device="cuda", max_batch=8, faults=parse_faults(faults) if faults else None)
    futs = [session.submit(q) for q in rmat15_queries(g)]
    if poison_kmax:
        session.faults = parse_faults(f"poison:times=*:where.query={futs[1].request.id}")
    case = LaunchCounts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    case.run(session.flush)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.fused += case.fused
    counts.support += case.support
    return session, futs, wall, case


def report_case(tag: str, session, wall: float, case) -> None:
    st = session.stats()
    log(f"phase10 {tag}: {wall:.2f}s wall; "
        + ", ".join(
        f"{k} {st[k]}" for k in RESILIENCE_KEYS + ("batch_bisects", "queries_failed"))
        + f"; launches fused_level_cuda {case.fused}, support_fine_cuda {case.support}")


def check_case_results(tag: str, futs, want, skip=()) -> None:
    for i, (name, f, w) in enumerate(zip(QUERIES, futs, want)):
        if i not in skip and not same_result(name, f.result(), w):
            raise AssertionError(f"phase10 {tag}: {name} != phase 5's")


def phase_resilience(torch, g, want, level_steps: int) -> dict:
    """Five faults through the main path's session on the card; returns the
    phase's in-process launches of the two peel kernels."""
    import repro_torch.kernels.peel_fused as kpf
    from repro_torch.api import QueryFailedError
    from repro_torch.errors import DeviceError, InvalidGraphError

    counts = LaunchCounts()

    # 1. An injected compile fault on the fused backend: one step down.
    s, futs, wall, case = resilience_case(
        torch, g, "compile:times=1:where.backend=fine/fused/aligned", counts)
    report_case("compile fault on fine/fused/aligned", s, wall, case)
    ran = {str(f.stats.backend) for f in futs}
    trips = futs[0].stats.dispatch_trips
    if ran != {"fine/pallas/aligned"} or s.backend_fallbacks != 1 or s.retries:
        raise AssertionError(f"compile fault: ran on {ran}, {s.stats()}")
    if case.support != trips or trips == 0 or case.fused:
        raise AssertionError(f"compile fault: support launches {case.support} over {trips} trips, "
                             f"fused {case.fused}")
    check_case_results("compile fault", futs, want)

    # 2. An injected dispatch fault: one retry on the same backend.
    s, futs, wall, case = resilience_case(torch, g, "dispatch:times=1", counts)
    report_case("dispatch fault", s, wall, case)
    steps = int(s.obs.metrics.value("peel_fused_levels"))
    if s.retries != 1 or s.backend_fallbacks or {str(f.stats.backend) for f in futs} != {
            "fine/fused/aligned"}:
        raise AssertionError(f"dispatch fault: {s.stats()}")
    if case.fused != steps or steps != level_steps or case.support:
        raise AssertionError(f"dispatch fault: fused launches {case.fused}, level steps {steps} "
                             f"(phase 5: {level_steps}), support {case.support}")
    check_case_results("dispatch fault", futs, want)

    # 3. The kmax query poisoned: it alone fails, typed.
    s, futs, wall, case = resilience_case(torch, g, None, counts, poison_kmax=True)
    report_case("kmax poisoned", s, wall, case)
    try:
        futs[1].result()
        raise AssertionError("the poisoned kmax query resolved")
    except QueryFailedError as e:
        if e.query_id != futs[1].request.id or not isinstance(e.cause, InvalidGraphError) \
                or not e.cause.injected:
            raise AssertionError(f"poisoned kmax failed as {e!r} (cause {e.cause!r})") from e
    if s.queries_quarantined != 1 or s.queries_failed != 1:
        raise AssertionError(f"kmax poisoned: {s.stats()}")
    check_case_results("kmax poisoned", futs, want, skip=(1,))

    # 4. A real kernel fault: the fused launch refused, through the wrapper's
    # own error path; no retry, no fallback, no plain level.
    built = kpf.load_peel_fused()
    launch, plain = built.lib.peel_fused_launch, kpf.fused_level_torch
    plain_calls = []

    def refused(*args):
        return COOPERATIVE_LAUNCH_TOO_LARGE

    def plain_spy(*args, **kwargs):
        plain_calls.append(1)
        raise AssertionError("the fused level's plain version ran")

    built.lib.peel_fused_launch, kpf.fused_level_torch = refused, plain_spy
    try:
        s, futs, wall, case = resilience_case(torch, g, None, counts)
    finally:
        built.lib.peel_fused_launch, kpf.fused_level_torch = launch, plain
    report_case("fused launch refused (cudaError 720)", s, wall, case)
    causes = []
    for f in futs:
        try:
            f.result()
            raise AssertionError("a query resolved although its launch was refused")
        except QueryFailedError as e:
            causes.append(e.cause)
            if not isinstance(e.cause, DeviceError) or e.cause.site != "fused_level" \
                    or e.cause.injected or not e.cause.kernel_fault \
                    or [str(b) for b in e.backends_tried] != [
                        "fine/fused/aligned"]:
                raise AssertionError(f"kernel fault surfaced as {e!r} (cause {e.cause!r}, "
                                     f"backends {e.backends_tried})") from e
    if s.retries or s.backend_fallbacks or s.batch_bisects or case.support or case.fused \
            or plain_calls:
        raise AssertionError(f"kernel fault was retried or answered elsewhere: {s.stats()}, "
                             f"launches {case.fused}/{case.support}, plain {len(plain_calls)}")
    log(f"phase10 kernel fault: every query QueryFailedError <- {causes[0]}")
    again = [s.submit(q) for q in rmat15_queries(g)]
    case = LaunchCounts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    case.run(s.flush)
    torch.cuda.synchronize()
    counts.fused += case.fused
    check_case_results("served again after the kernel fault", again, want)
    if case.fused != level_steps:
        raise AssertionError(f"served again: {case.fused} fused launches, expected {level_steps}")
    log(f"phase10 the same session serves the batch again: {time.perf_counter() - t0:.2f}s, "
        f"{case.fused} fused launches, == phase 5")

    # 5. A real OOM allocating the fused kernel's scratch (its sizing asks
    # for 4 TiB): a kernel fault too, with no plain level and no step down.
    sizing = kpf.scratch_elements
    kpf.scratch_elements = lambda *a: {**sizing(*a), "acc": 1 << 40}
    kpf.fused_level_torch = plain_spy
    try:
        s, futs, wall, case = resilience_case(torch, g, None, counts)
    finally:
        kpf.scratch_elements, kpf.fused_level_torch = sizing, plain
    report_case("fused scratch OOM", s, wall, case)
    for f in futs:
        try:
            f.result()
            raise AssertionError("a query resolved although its kernel's scratch was refused")
        except QueryFailedError as e:
            if not isinstance(e.cause, DeviceError) or not e.cause.oom \
                    or not e.cause.kernel_fault \
                    or not isinstance(e.cause.cause, torch.OutOfMemoryError) \
                    or [str(b) for b in e.backends_tried] != ["fine/fused/aligned"]:
                raise AssertionError(f"scratch OOM surfaced as {e!r} (cause {e.cause!r}, "
                                     f"backends {e.backends_tried})") from e
    if s.retries or s.backend_fallbacks or s.batch_bisects or case.support or case.fused \
            or plain_calls:
        raise AssertionError(f"scratch OOM was retried or answered elsewhere: {s.stats()}, "
                             f"launches {case.fused}/{case.support}, plain {len(plain_calls)}")
    log("phase10 scratch OOM: every query QueryFailedError <- DeviceError(oom=True) "
        "<- torch.OutOfMemoryError, nothing else ran")
    return dict(fused=counts.fused, support=counts.support)


FLEET_WARMUP = {"kind": "rmat", "scale": 15, "edge_factor": 8, "seed": 21}  # rmat-15


def phase_fleet(torch, g, want, p5_wall: float) -> None:
    """Two replica processes on the card: solve, health, a stream handed off."""
    import tempfile

    import numpy as np

    from repro_torch.api import Session, bucket_for, bucket_str
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.serve import Fleet, FleetClient

    libs = sorted(p.name for p in BUILD_DIR.iterdir())
    b1, b2 = balanced_batches(np.random.default_rng(7), g, 16, 2)  # phase 9's width-16 pair
    local = Session(max_batch=8, device="cuda").open_stream(g, trussness=want[0].trussness)
    local.update(b1)
    lres = local.update(b2)
    with tempfile.TemporaryDirectory() as tmp:  # what each fleet update also writes
        t0 = time.perf_counter()
        local.checkpoint(f"{tmp}/stream.npz")
        ckpt_s = time.perf_counter() - t0
    del local
    torch.cuda.empty_cache()
    label = bucket_str(bucket_for(g, chunk=256))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with Fleet(2, workdir=tmp, device="cuda", max_batch=8, warmup=[FLEET_WARMUP],
                   warmup_all=True) as fleet:
            start_s = time.perf_counter() - t0
            client = FleetClient(fleet)
            t0 = time.perf_counter()
            got = client.solve(rmat15_queries(g))
            solve_s = time.perf_counter() - t0
            for name, r, w in zip(QUERIES, got, want):
                if not same_result(name, r, w):
                    raise AssertionError(f"fleet {name} != phase 5's")
            reports = fleet.router.poll_health()
            for name, rep in sorted(reports.items()):
                if label not in rep.compiled_buckets or rep.warmup_queries != 1:
                    raise AssertionError(f"{name}: buckets {rep.compiled_buckets}, "
                                         f"warmup {rep.warmup_queries}")
                if rep.retries or rep.queries_quarantined or rep.queries_failed:
                    raise AssertionError(f"{name}: {rep}")
            if len(reports) != 2:
                raise AssertionError(f"health from {sorted(reports)} only")
            st = client.stats()
            if st["routed"] != st["affinity_hits"] + st["spillovers"] + st["cold_assignments"]:
                raise AssertionError(f"router accounting: {st}")
            log(f"phase10 fleet: 2 replicas up in {start_s:.2f}s (spawn, CUDA init, rmat-15 "
                f"warmup each); solve {solve_s:.2f}s through the fleet vs {p5_wall:.2f}s "
                f"in-process (phase 5), == phase 5; both replicas hold {label}; routed "
                f"{st['routed']} = {st['affinity_hits']} affinity + {st['spillovers']} spill + "
                f"{st['cold_assignments']} cold")
            t0 = time.perf_counter()
            stream = client.open_stream(g)
            open_s = time.perf_counter() - t0
            owner = stream.owner
            t0 = time.perf_counter()
            stream.update(b1)
            update_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            fleet.kill(owner)
            kill_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            reply = stream.update(b2)
            handoff_s = time.perf_counter() - t0
            handoffs = int(fleet.router.metrics.value("fleet_stream_handoffs",
                                                      stream=stream.stream_id))
            if stream.owner == owner or stream.seq != 2 or reply["seq"] != 2 or handoffs < 1:
                raise AssertionError(f"handoff: owner {owner} -> {stream.owner}, seq "
                                     f"{stream.seq}, handoffs {handoffs}")
            if not np.array_equal(stream.trussness, lres.trussness) or stream.kmax != lres.kmax:
                raise AssertionError("the handed-off stream != the in-process stream")
            log(f"phase10 fleet stream: open {open_s:.2f}s, width-16 update {update_s:.2f}s on "
                f"{owner}; kill + warm restore on the survivor {kill_s:.2f}s; the second update "
                f"{handoff_s:.2f}s on {stream.owner} (seq 2, frontier {reply['frontier_size']}), "
                f"== the in-process stream; fleet_stream_handoffs {handoffs}; each replica "
                f"update also writes a checkpoint: {ckpt_s:.2f}s for the same state in process")
    if sorted(p.name for p in BUILD_DIR.iterdir()) != libs:
        raise AssertionError("a replica built a kernel library (phase 1's should be reused)")
    log(f"phase10 replicas reused phase 1's libraries: kernels/_build/ unchanged ({len(libs)} files)")


def shard_trips(session, g) -> list:
    """Wrap ``session``'s ``fine/pallas/aligned`` executor for ``g``'s bucket
    so that each dispatch appends its per-shard trips: a shard's trips are
    the longest run of its slots (the lock step stops it there)."""
    exe = executor_of(session, g, "fine/pallas/aligned", built=False)
    d, peel, seen = session.mesh.size, exe.peel, []

    def counted(*args, **kw):
        st = peel(*args, **kw)
        trips = st.iters.view(d, -1).max(1).values.tolist()
        if int(st.total_iters) != max(trips):
            raise AssertionError(f"total_iters {int(st.total_iters)} != the longest shard {trips}")
        seen.append(trips)
        return st

    exe.peel = counted
    return seen


def check_mesh_case(tag: str, session, futs, want, trips, counts, wall: float, p3_wall: float):
    """One mesh case: one fine/pallas/aligned dispatch, the support kernel
    launched once per trip of every shard, no fused launch, every shard
    that holds a member (slots from 0) taking trips and no other, and
    every answer equal to phase 5's."""
    st = session.stats()
    backends = {row["backend"] for row in st["planner_backends"]}
    log(f"phase11 {tag}: {wall:.2f}s wall (phase 3: {p3_wall:.2f}s), {session.mesh.size} "
        f"shard(s) on {[str(d) for d in session.mesh.devices]}, backend {sorted(backends)}, "
        f"dispatches {st['device_dispatches']}, trips per shard {trips}, support_fine_cuda "
        f"launches {counts.support}, fused launches {counts.fused}")
    if backends != {"fine/pallas/aligned"}:
        raise AssertionError(f"phase11 {tag}: planner chose {backends}")
    if st["device_dispatches"] != 1 or len(trips) != 1:
        raise AssertionError(f"phase11 {tag}: {st['device_dispatches']} dispatches")
    per_shard = session.max_batch // session.mesh.size
    live = [j * per_shard < len(futs) for j in range(session.mesh.size)]
    if counts.fused or counts.support != sum(trips[0]) or [t > 0 for t in trips[0]] != live:
        raise AssertionError(f"phase11 {tag}: {counts.support} support launches over the shards' "
                             f"trips {trips[0]} ({counts.fused} fused launches)")
    for i, f in enumerate(futs):
        name = QUERIES[i % len(QUERIES)]
        if not same_result(name, f.result(), want[i % len(QUERIES)]):
            raise AssertionError(f"phase11 {tag}: {name} != phase 5's")


def phase_mesh(torch, g, want, p3_wall: float) -> dict:
    """The mesh path on the card: ``Session(mesh=)``, a two-shard mesh on one
    card, ``TrussService(mesh=)``, a stream update on a mesh session; then
    the recompile sentinel on a warm repeat of phase 5, and the analysis
    suite.  Returns the support kernel's launches on these paths."""
    import functools

    import numpy as np

    from repro_torch.analysis.sentinel import assert_no_compiles, count_compiles
    from repro_torch.api import Session
    from repro_torch.distributed import slot_mesh
    from repro_torch.service import TrussService
    from repro_torch.stream import apply_batch

    t11 = time.perf_counter()
    counts = LaunchCounts()

    def batch_on(session, queries):
        futs = [session.submit(q) for q in queries]
        session.flush()
        return futs

    # A. Session(max_batch=8, mesh=slot_mesh()): the auto rule steps
    # fine/fused/aligned down to fine/pallas/aligned.
    session = Session(max_batch=8, mesh=slot_mesh())
    trips = shard_trips(session, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = counts.run(lambda: batch_on(session, rmat15_queries(g)))
    torch.cuda.synchronize()
    check_mesh_case("A Session(mesh=slot_mesh())", session, futs, want, trips, counts,
                    time.perf_counter() - t0, p3_wall)
    a_support = counts.support

    # B. The batch twice over (slots 0-5), first on every visible card,
    # then on two shards of one card, 4 slots each, so that both shards
    # hold live members.  Shards on one card run one after the other on
    # its default stream.
    b_support = 0
    for tag, mesh in (("B1 the batch twice, slot_mesh()", slot_mesh()),
                      ("B2 the batch twice, two shards on cuda:0",
                       slot_mesh(devices=("cuda:0", "cuda:0")))):
        counts = LaunchCounts()
        session = Session(max_batch=8, mesh=mesh)
        trips = shard_trips(session, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = counts.run(functools.partial(batch_on, session, 2 * rmat15_queries(g)))
        torch.cuda.synchronize()
        check_mesh_case(tag, session, futs, want, trips, counts, time.perf_counter() - t0, p3_wall)
        b_support += counts.support

    # C. The legacy adapter on a mesh.
    counts = LaunchCounts()
    svc = TrussService(backend="pallas", mesh=slot_mesh())
    if svc.mesh is not svc.session.mesh:
        raise AssertionError("TrussService.mesh is not its session's")
    trips = shard_trips(svc.session, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def service_batch():
        futs = [svc.submit_decompose(g), svc.submit_kmax(g), svc.submit_ktruss(g, 4)]
        svc.flush()
        return futs

    futs = counts.run(service_batch)
    torch.cuda.synchronize()
    check_mesh_case("C TrussService(backend='pallas', mesh=slot_mesh())", svc.session, futs,
                    want, trips, counts, time.perf_counter() - t0, p3_wall)
    c_support = counts.support
    del svc, session, futs

    # D. Width-16 stream updates on a mesh session: one stream on
    # slot_mesh(); then two streams on two shards of cuda:0, one slot each,
    # their updates coalesced into one dispatch, so that the second shard's
    # frozen lanes are rebased and go through the support kernel.
    d_support = 0
    for tag, mesh, max_batch, seeds in (
            ("D1 one stream, slot_mesh()", slot_mesh(), 8, (7,)),
            ("D2 two streams, two shards on cuda:0", slot_mesh(devices=("cuda:0", "cuda:0")), 2,
             (100, 101))):
        counts = LaunchCounts()
        session = Session(max_batch=max_batch, mesh=mesh)
        streams = [session.open_stream(g, trussness=want[0].trussness) for _ in seeds]
        batches = [balanced_batches(np.random.default_rng(s), g, 16, 1)[0] for s in seeds]
        trips = shard_trips(session, apply_batch(g, batches[0]).new_graph)  # the update's bucket
        torch.cuda.synchronize()
        before = session.device_dispatches
        t0 = time.perf_counter()
        pend = [st.submit_update(b) for st, b in zip(streams, batches)]
        counts.run(session.flush)
        results = [pu.result() for pu in pend]
        wall = time.perf_counter() - t0
        scratch = scratch_trussness(
            Session(max_batch=8, device="cuda", backend="fine/pallas/aligned"),
            [st.graph for st in streams])
        dispatches = session.device_dispatches - before
        log(f"phase11 {tag}: stream update (width 16) on Session(mesh=), {wall:.2f}s wall, "
            f"frontiers {[r.frontier_size for r in results]}, dispatches {dispatches}, "
            f"trips per shard {trips}, support_fine_cuda launches {counts.support}, "
            f"fused launches {counts.fused}")
        per_shard = max_batch // mesh.size
        live = [j * per_shard < len(seeds) for j in range(mesh.size)]
        if (dispatches != 1 or len(trips) != 1 or counts.fused or counts.support != sum(trips[0])
                or [t > 0 for t in trips[0]] != live):
            raise AssertionError(f"phase11 {tag}: {dispatches} dispatches, trips {trips}, "
                                 f"{counts.support} support launches, {counts.fused} fused")
        for r, w in zip(results, scratch):
            if not np.array_equal(r.trussness, w):
                raise AssertionError(f"phase11 {tag}: an update != a from-scratch "
                                     "fine/pallas/aligned decompose")
        d_support += counts.support
        del streams, pend, results, session

    # The recompile sentinel: phase 5's batch on a fresh session builds its
    # executor and no kernel (phase 1 built them), and on fine/pallas/aligned
    # captures the trip graph once; the warm repeat builds and captures
    # nothing.
    for backend, captures in ((None, 0), ("fine/pallas/aligned", 1)):
        session = Session(max_batch=8, device="cuda", backend=backend)
        with count_compiles() as cold:
            session.solve(rmat15_queries(g))
        t0 = time.perf_counter()
        with assert_no_compiles("phase 5's batch, warm") as hot:
            again = session.solve(rmat15_queries(g))
        warm = time.perf_counter() - t0
        got = (cold.kernel_builds, cold.executor_builds, cold.captures)
        if got != (0, 1, captures) or hot.captures:
            raise AssertionError(f"phase11 cold run on {backend or 'the auto rule'}: (kernel "
                                 f"builds, executor builds, captures) {got}, want (0, 1, "
                                 f"{captures}); warm captures {hot.captures}")
        for name, a, b in zip(QUERIES, again, want):
            if not same_result(name, a, b):
                raise AssertionError(f"phase11 warm repeat: {name} != phase 5's")
        log(f"phase11 sentinel ({backend or 'auto rule'}): cold run {cold.kernel_builds} kernel "
            f"builds, {cold.executor_builds} executor build, {cold.captures} trip-graph "
            f"capture(s); warm repeat {warm:.2f}s, 0 builds, 0 captures, == phase 5")
        del session, again

    # The port's analysis suite on this copy of the tree.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root", str(ROOT)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300,
    )
    log(f"phase11 python -m repro_torch.analysis: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f}s: {proc.stdout.strip().splitlines()}")
    if proc.returncode:
        raise AssertionError(f"repro_torch.analysis failed:\n{proc.stdout}{proc.stderr}")
    log(f"phase11 {time.perf_counter() - t11:.1f}s")
    return {"support": a_support + b_support + c_support + d_support}


EXAMPLES = ("declarative_queries", "quickstart", "ktruss_scaling", "tracing", "streaming_updates")
def check_oracle(queries, results, what: str) -> None:
    """Each answer against ``trussness_numpy`` of its graph (small graphs)."""
    from repro_torch.core import trussness_numpy

    for q, r in zip(queries, results):
        t = trussness_numpy(q.graph)
        kmax = int(t.max()) if t.size else 0
        if q.workload == "decompose":
            ok = (r.kmax, bool((r.trussness == t).all())) == (kmax, True)
        elif q.workload == "kmax":
            ok = r == (kmax if kmax >= 3 else 0)
        else:
            ok = bool((r.alive == (t >= q.k)).all())
        if not ok:
            raise AssertionError(
                f"phase12 {what}: {q.workload} on {q.graph.name} != trussness_numpy")


def phase_examples(torch, g, want) -> dict:
    """The five example twins on the card: (a) each ``main(device="cuda")``
    at the example's own size; (b) the scaling sweep over every
    BENCH_GRAPHS graph at full width; (c) the main path's span split,
    cold and warm, on rmat-15's phase-5 batch.  No session of the phase
    may retry, fall back or see a fault.  Returns the launches of the two
    peel kernels."""
    import contextlib
    import importlib
    import io
    import tempfile

    from repro_torch.api import TrussQuery, bucket_for
    from repro_torch.configs import BENCH_GRAPHS
    from repro_torch.examples.ktruss_scaling import SETTINGS, sweep

    t12 = time.perf_counter()
    counters0 = resilience_counters()
    counts = LaunchCounts()
    tmp = tempfile.TemporaryDirectory()

    # (a) Each twin as a user runs it, with the example's own checks.
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        kw = {"trace": str(Path(tmp.name) / "trace.json")} if name == "tracing" else {}
        support0, fused0 = counts.support, counts.fused
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            got = counts.run(lambda: mod.main(device="cuda", **kw))
        wall = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"phase12 {name} | {line}")
        if name == "declarative_queries":
            backends = got["planner_backends"]
            check_oracle([TrussQuery.decompose(mod.one_shot_graph())] + mod.mixed_queries(),
                         [got["one_shot"]] + got["results"], name)
            # The one-shot solve alone runs a hand kernel here (the session asks
            # for kernel="xla"): on rmat8 (skewed) the auto rule's fused kernel,
            # one launch per level.
            if counts.fused - fused0 != got["one_shot"].levels:
                raise AssertionError(f"phase12 {name}: {counts.fused - fused0} fused launches, "
                                     f"{got['one_shot'].levels} levels")
        elif name == "quickstart":
            backends = "none (KTrussEngine's ktruss and support run no Session)"
            # fine/owner/pallas: one support_fine_cuda launch per ktruss(4)
            # trip and one timed call.
            trips = got["ktruss4"]["fine/owner/pallas"].iterations
            if counts.support - support0 != trips + 1:
                raise AssertionError(f"phase12 {name}: {counts.support - support0} "
                                     f"support_fine_cuda launches, not {trips} trips + 1")
        elif name == "tracing":
            backends = [f"{r['bucket']} -> {r['backend']}" for r in got["imbalance"]]
            check_oracle(mod.example_queries(), got["results"], name)
        elif name == "streaming_updates":
            backends = got["service"]["planner_backends"]
        else:
            backends = "none (KTrussEngine's ktruss and support run no Session)"
        log(f"phase12 {name}: {wall:.2f}s; planner_backends {backends}; support_fine_cuda "
            f"launches {counts.support - support0}, fused_level_cuda launches "
            f"{counts.fused - fused0}")
    part_a = (counts.support, counts.fused)

    # (b) The scaling sweep at full width: every BENCH_GRAPHS graph, the
    # reference example's two engines and the hand kernel.
    settings = SETTINGS + (("fine", "owner", "pallas"),)
    tags = ["/".join(s) for s in settings]
    reps = 3
    t0 = time.perf_counter()
    for b in BENCH_GRAPHS:
        gb = b.build()
        # The coarse pass pads every row to W (KTrussEngine's coarse window:
        # the largest out-degree rounded up to 8) in both dimensions, and
        # support_coarse_eager walks it in blocks of at most 2^22 lanes for
        # any W up to 2048, so its memory does not grow with the graph and
        # no BENCH_GRAPHS graph is too large for the card; the peak below
        # is measured.
        w = max(8, -(-gb.max_degree() // 8) * 8)
        lanes = gb.n * w * w
        log(f"phase12 sweep {b.name} coarse pass: W {w}, {lanes:.3g} padded lanes, "
            f"{8 * lanes / 1e9:.2f} GB read a pass (an int32 query and window entry each)")
        torch.cuda.reset_peak_memory_stats()
        tg = time.perf_counter()
        support0 = counts.support
        (row,) = counts.run(lambda: sweep([gb], settings, device="cuda", reps=reps))
        kt = [row.ktruss[t] for t in tags]
        if not all((r.alive == kt[0].alive).all() and (r.support == kt[0].support).all()
                   and r.iterations == kt[0].iterations for r in kt):
            raise AssertionError(f"phase12 sweep {b.name}: the settings disagree on ktruss(4)")
        # Only the fine/owner/pallas column launches the hand kernel: once per
        # ktruss(4) trip and once per timed call.
        if counts.support - support0 != kt[-1].iterations + reps:
            raise AssertionError(f"phase12 sweep {b.name}: {counts.support - support0} "
                                 f"support_fine_cuda launches, not {kt[-1].iterations} "
                                 f"trips + {reps}")
        times = ", ".join(f"{t} {row.ms[t]:.3f} ms" for t in tags)
        ratios = ", ".join(f"{tags[0]} / {t} {row.ms[tags[0]] / row.ms[t]:.1f}x"
                           for t in tags[1:])
        log(f"phase12 sweep {b.name}: n={row.n} nnz={row.nnz} maxdeg/avg {row.pred:.1f} "
            f"coarse_imbalance {row.coarse_imbalance:.1f}; {times}; {ratios}; ktruss(4) "
            f"{kt[0].edges_remaining} edges in {kt[0].iterations} trips, all agree; "
            f"support_fine_cuda launches {counts.support - support0}; "
            f"{time.perf_counter() - tg:.1f}s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"phase12 sweep: {time.perf_counter() - t0:.1f}s over {len(BENCH_GRAPHS)} graphs; "
        f"support_fine_cuda launches {counts.support - part_a[0]}")
    part_b = (counts.support, counts.fused)

    # (c) The main path's span split: rmat-15's phase-5 batch, cold then warm,
    # on fine/fused/aligned alone: one fused launch per level step, no
    # support kernel, no retry, no step down.
    check_pack(torch, "phase12 rmat-15", [g, g, g], bucket_for(g, chunk=256))
    span_split(torch, "phase12 rmat-15", g, want, "fine/fused/aligned", counts)
    submit_latency(torch, "phase12 rmat-15", g, want, SUBMIT_UNDER["rmat-15"])
    tmp.cleanup()

    moved = {k: v - counters0.get(k, 0) for k, v in resilience_counters().items()
             if v != counters0.get(k, 0)}
    if moved:
        raise AssertionError(f"phase12 moved resilience counters: {moved}")
    log(f"phase12 examples: {time.perf_counter() - t12:.1f}s; launches (a) support "
        f"{part_a[0]} fused {part_a[1]}, (b) support {part_b[0] - part_a[0]}, (c) fused "
        f"{counts.fused - part_b[1]} support {counts.support - part_b[0]}; retries, "
        f"backend_fallbacks, faults_injected, queries_quarantined unmoved over every session")
    return {"support": counts.support, "fused": counts.fused}


def support_only(torch, g, bucket, smi, sets_file: Path) -> int:
    """Phase 2 and phase 3's kernel/rest split alone, for comparing the
    support kernel of two trees in one session: the alive sets of the
    peel are read from ``sets_file`` when it exists (written by an
    earlier run), else taken from this run's peel and written there."""
    phase_kernel(torch, g, bucket)
    p = main_path_problem(g, bucket, slots=8)
    eager = eager_trip_loop(torch, p, bucket)  # any tree's peel: it may have no trip graph
    report_peel_split("phase3", None, eager)
    handed = eager[3]
    del eager
    if sets_file.exists():
        sets = {k: v.cuda() for k, v in torch.load(sets_file).items()}
        log(f"peel alive sets read from {sets_file}")
    else:
        sets = peel_sets(handed)
        torch.save({k: v.cpu() for k, v in sets.items()}, sets_file)
        log(f"peel alive sets written to {sets_file}")
    del handed
    phase_peel_sets(torch, p, bucket, sets)
    del p, sets
    profiled_peel(torch, g, bucket, check=False)
    log(smi)
    return 0


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--support-only", action="store_true",
                    help="run only the support kernel's phases (2 and 3's split)")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch to import (default: this checkout's)")
    ap.add_argument("--sets", type=Path, default=None,
                    help="with --support-only: file of the peel's alive sets (read, or written)")
    ap.add_argument("--prep-only", action="store_true",
                    help="run only the graph preparation of phases 12 (c) and 13: the packs "
                         "against the CPU's, their times and bytes, the span splits, the "
                         "submit latencies")
    ap.add_argument("--stream-only", action="store_true",
                    help="run only phase 9's stream updates (span split by width, bytes copied, "
                         "the card against the CPU) and its coalesced and concurrent submits")
    ap.add_argument("--mesh-only", action="store_true",
                    help="time only phases 1, 3, 5 and 11 (the mesh path, on every visible card); "
                         "no kernel check, no result line")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (args.src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    if args.support_only and args.sets is None:
        print("chip_smoke: --support-only needs --sets", file=sys.stderr)
        return 2
    if os.environ.get("REPRO_FAULTS"):
        print("chip_smoke: REPRO_FAULTS is set; no fault may be injected into the smoke run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.api import bucket_for
    from repro_torch.configs import LARGE_GRAPHS

    t_start = time.perf_counter()
    smi = phase_setup(torch)
    g = next(b for b in LARGE_GRAPHS if b.name == "rmat-15").build()
    bucket = bucket_for(g, chunk=256)
    log(f"rmat-15: n={g.n} nnz={g.nnz} bucket={tuple(bucket)}")
    if args.support_only:
        return support_only(torch, g, bucket, smi, args.sets)
    if args.prep_only:
        return prep_only(torch, smi, args.src)
    if args.stream_only:
        return stream_only(torch, g, smi, args.src)
    if args.mesh_only:
        _, pallas_futs, pallas_wall, _ = phase_pallas_path(torch, g)
        _, fused_futs, _ = phase_fused_main(torch, g, pallas_futs, pallas_wall)
        want = [f.result() for f in fused_futs]
        with_captures("phase11", lambda: phase_mesh(torch, g, want, pallas_wall))
        log(smi)
        return 0
    numbers = phase_kernel(torch, g, bucket)
    launches, pallas_futs, pallas_wall, trips = phase_pallas_path(torch, g)
    p, want, handed = phase_peel_split(torch, g, bucket, "phase3", trips)
    sets = peel_sets(handed)
    del handed
    phase_peel_sets(torch, p, bucket, sets)
    del p, sets, want
    phase_paths(torch)
    fused_launches, fused_futs, fused_wall = phase_fused_main(torch, g, pallas_futs, pallas_wall)
    fused_numbers = phase_fused_kernel(torch, g, bucket)
    dense_numbers = phase_dense(torch, g)
    phase_engine(torch, g, pallas_futs, smi)
    stream = with_captures("phase9", lambda: phase_stream(torch, g, fused_futs[0].result()))
    want = [f.result() for f in fused_futs]
    del fused_futs
    check_phases_clean()
    t10 = time.perf_counter()

    def phase10():
        out = phase_resilience(torch, g, want, fused_launches)
        phase_fleet(torch, g, want, fused_wall)
        return out

    resilience = with_captures("phase10", phase10)
    log(f"phase10 {time.perf_counter() - t10:.1f}s")
    mesh = with_captures("phase11", lambda: phase_mesh(torch, g, want, pallas_wall))
    examples = phase_examples(torch, g, want)
    t13 = time.perf_counter()
    road = phase_road(torch)
    log(f"phase13 {time.perf_counter() - t13:.1f}s")
    t14 = time.perf_counter()
    contig = phase_contig(torch, g, want)
    log(f"phase14 {time.perf_counter() - t14:.1f}s")
    del want
    profiled_peel(torch, g, bucket)
    for nums in (numbers, fused_numbers):  # the frozen-lane checks count too
        nums["max_abs_err"] = max(nums["max_abs_err"], stream["max_abs_err"])
    kernels = [
        dict(
            name="support_fine_cuda",
            route="cuda",
            source="src/repro_torch/kernels/csrc/support_fine.cu",
            replaces="src/repro/kernels/support_fine.py:86",
            launches=launches + stream["support"] + resilience["support"] + mesh["support"]
            + examples["support"] + road + contig,
            launches_by_path=dict(
                phase3=launches, phase9=stream["support"], phase10=resilience["support"],
                phase11=mesh["support"], examples=examples["support"], phase13=road,
                phase14_contig=contig,
            ),
            **numbers,
        ),
        dict(
            name="fused_level_cuda",
            route="cuda",
            source="src/repro_torch/kernels/csrc/peel_fused.cu",
            replaces="src/repro/kernels/peel_fused.py:260",
            launches=fused_launches + stream["fused"] + resilience["fused"] + examples["fused"],
            launches_by_path=dict(
                phase5=fused_launches, phase9=stream["fused"], phase10=resilience["fused"],
                examples=examples["fused"],
            ),
            **fused_numbers,
        ),
        dict(
            name="support_dense_cuda",
            route="cuda",
            source="src/repro_torch/kernels/csrc/support_dense.cu",
            replaces="src/repro/kernels/support_dense.py:45",
            launches_by_path=dict(phase7=dense_numbers["launches"]),
            **dense_numbers,
        ),
    ]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
