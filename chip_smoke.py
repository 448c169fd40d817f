#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. setup: the card's name and power limit; build the three hand-written
   kernel libraries (``support_fine.cu``, ``peel_fused.cu`` and
   ``support_dense.cu`` from ``src/repro_torch/kernels/csrc``, one ``nvcc``
   each, started together) and print nvcc's register, shared-memory and
   spill reports, the fused kernel's CTAs per SM (its cooperative grid)
   and the dense product's dynamic shared memory.
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
   ``backend="fine/pallas/aligned"``; checks one dispatch, that the kernel
   ran once per peel trip, and the results against each other and the
   numpy oracle.  Then the same batch through the executor alone, each
   support pass between CUDA events: the whole peel split into the
   kernel's passes and the rest of the trips, and the lanes handed to the
   kernel; and, at the very end of the run (the profiler slows every
   later launch of the process), once more under ``torch.profiler``: the
   device's busy share of the peel and the kernels with the most device
   time.
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
   frontier (recomputed by a full enumeration), with its wall and spans;
   ``fused_level_cuda``'s first level and ``support_fine_cuda`` on
   ``alive | frozen-live`` against their plain versions on two updates'
   lowered inputs (the first width-256 batch, the first width-1 batch);
   8 streams' updates on one session coalescing into one dispatch; a
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
   builds one executor and no kernel, its warm repeat builds nothing;
   and ``python -m repro_torch.analysis`` exits 0 on this copy of the
   tree.  The launches of phase 11 join ``support_fine_cuda``'s.
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
   beside ``max_degree / avg_degree`` and ``coarse_imbalance``; (c)
   ``tracing.traced_solve`` on phase 5's batch in a fresh traced
   ``Session(max_batch=8)`` (auto rule: ``fine/fused/aligned``), cold then
   warm, each span's ms and ``solve`` outside its child spans, the answers
   equal to phase 5's, one fused launch a level, no retry and no fallback.
   No resilience counter may move over phase 12.  Phase 12's launches are
   the kernels' ``launches_by_path["examples"]``.

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


def instrumented_peel(torch, g, bucket):
    """The rmat-15 batch peeled by the ``fine/pallas/aligned`` executor
    (no ``Session``) with each support pass between two CUDA events.
    Returns the problem, the executor's whole peel (ms, host clock), the
    support passes' summed device time (ms), the trips, and the alive set
    handed to the kernel on each trip (kept as clones, outside the events)."""
    from repro_torch.exec.peel import PeelExecutor
    from repro_torch.kernels import ops

    p = main_path_problem(g, bucket, slots=8)
    slot_ids, k0, single = main_path_slots(torch, bucket)
    events, handed = [], []

    def support(prob, alive):
        handed.append(alive.clone())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = ops.support_fine(prob, alive, window=bucket.window, chunk=256)
        end.record()
        events.append((start, end))
        return out

    exe = PeelExecutor(support=support)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = exe.peel(p, slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    support_ms = sum(a.elapsed_time(b) for a, b in events)
    if len(events) != int(st.total_iters):
        raise AssertionError(f"{len(events)} support passes over {int(st.total_iters)} trips")
    return p, whole_ms, support_ms, len(events), handed


def report_peel_split(tag: str, whole_ms, support_ms, trips, handed) -> None:
    lanes = sum(int(m.sum()) for m in handed)
    log(f"{tag} executor peel (instrumented, {trips} trips): whole {whole_ms:.1f} ms; support passes "
        f"{support_ms:.1f} ms of device time (CUDA events, {support_ms / trips:.4f} ms a pass); "
        f"rest of the trip {whole_ms - support_ms:.1f} ms ({(whole_ms - support_ms) / trips:.3f} ms "
        f"a trip); lanes handed to the kernel {lanes} over the trips ({lanes / trips:.0f} a trip)")


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


def phase_pallas_path(torch, g):
    from repro_torch.kernels import support_fine_cuda

    support_fine_cuda.launches = 0
    session, futs, wall = run_session(torch, g, backend="fine/pallas/aligned")
    launches = support_fine_cuda.launches
    st = session.stats()
    dec, _, kt = (f.result() for f in futs)
    trips = futs[0].stats.dispatch_trips
    log(
        f"phase3 rmat-15 fine/pallas/aligned: {wall:.2f}s wall, dispatches "
        f"{st['device_dispatches']}, total_iters {trips}, launches {launches}, host syncs "
        f"{executor_of(session, g, 'fine/pallas/aligned').host_syncs}, levels {dec.levels}, "
        f"kmax {dec.kmax}, ktruss(4) edges {kt.edges_remaining}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    if st["device_dispatches"] != 1:
        raise AssertionError(f"{st['device_dispatches']} dispatches for one bucket")
    if launches != trips or trips == 0:
        raise AssertionError(f"kernel launched {launches} times over {trips} peel trips")
    check_rmat15_results(g, futs)
    return launches, futs, wall, trips


def profiled_peel(torch, g, bucket) -> None:
    """Phase 3's peel once more under ``torch.profiler`` (device activity
    only): the device's busy share of the peel's wall, and the kernels that
    take the most device time.  Run last: once the profiler has been
    active, later launches in the process are slower."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.exec.peel import PeelExecutor

    p = main_path_problem(g, bucket, slots=8)
    slot_ids, k0, single = main_path_slots(torch, bucket)
    exe = PeelExecutor(mode="owner", backend="pallas", window=bucket.window, chunk=256)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.peel(p, slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    if not kernels:
        log("phase3 profiled peel: the profiler saw no device time")
        return
    top = sorted(kernels, key=device_us, reverse=True)[:5]
    log(f"phase3 profiled peel: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%} of the wall; idle {1 - busy_ms / wall_ms:.1%}); top kernels by "
        "device time: " + "; ".join(
            f"{e.key[:60]} {device_us(e) / 1e3:.1f} ms in {e.count} launches "
            f"({device_us(e) / 1e3 / busy_ms:.1%})" for e in top))


def phase_peel_split(torch, g, bucket, session_trips: int | None = None):
    """Phase 3's peel again, through the executor alone, split into the
    support passes and the rest of each trip; returns the problem and the
    alive sets handed to the kernel."""
    p, whole_ms, support_ms, trips, handed = instrumented_peel(torch, g, bucket)
    if session_trips is not None and trips != session_trips:
        raise AssertionError(f"executor peel took {trips} trips, the session's {session_trips}")
    report_peel_split("phase3", whole_ms, support_ms, trips, handed)
    return p, handed


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
    st0 = init_peel_state(slot_ids, k0, p.colidx != 0, frozen, ftruss)
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
STREAM_BATCHES = 2  # per width
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


def independent_frontier(g_old, t_old, batch):
    """The update's delta, its frontier by a full enumeration of the union
    graph on the card (not the session's cache), and the carried
    trussness on the new graph's edges."""
    import numpy as np

    from repro_torch.stream import apply_batch, compute_frontier

    delta = apply_batch(g_old, batch)
    fr = compute_frontier(t_old, delta, device="cuda")
    carry = np.full(delta.new_graph.nnz, 2, np.int32)
    shared = delta.new2old >= 0
    carry[shared] = t_old[delta.new2old[shared]]
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
    st0 = init_peel_state(slot_ids, k0, alive0, frozen, ftruss)
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


def phase_stream(torch, g, dec) -> dict:
    """Streaming K-truss on the card at full width (rmat-15); returns the
    stream path's launches of the two peel kernels."""
    import statistics
    import tempfile

    import numpy as np

    from repro_torch.api import Session, bucket_for
    from repro_torch.core import prepare_fine
    from repro_torch.kernels import support_fine_cuda
    from repro_torch.resilience import restore_session
    from repro_torch.service import TrussService
    from repro_torch.stream import ENUM_COUNTS, EdgeBatch, edge_triangles

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
    for width in STREAM_WIDTHS:
        for i, batch in enumerate(balanced_batches(rng, stream.graph, width, STREAM_BATCHES)):
            g_old, t_old = stream.graph, stream.trussness
            delta, fr, carry = independent_frontier(g_old, t_old, batch)
            exe = executor_of(session, delta.new_graph, "fine/fused/aligned", built=False)
            tracer.clear()
            with PeelCapture(exe) as cap:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = counts.run(lambda b=batch: stream.update(b))
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            spans = span_ms(tracer)
            want = scratch_trussness(scratch, [delta.new_graph])[0]
            check_update(res, fr, carry, want, f"width {width} batch {i}")
            if (width, i) in HELD_UPDATES:
                if len(cap.calls) != 1:
                    raise AssertionError(f"the width-{width} update made {len(cap.calls)} peels")
                held[width, i] = (cap.calls[0], exe)
            log(f"phase9 width {width} batch {i}: +{res.num_inserts}/-{res.num_deletes}, frontier "
                f"{res.frontier_size} ({res.frontier_frac:.4f} of {res.num_edges}), closure rounds "
                f"{fr.rounds}, union triangles {fr.num_triangles}, dispatches {res.dispatches}; "
                f"update wall {wall_ms:.1f} ms = " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in spans.items())
                + f", outside spans {wall_ms - sum(spans.values()):.1f} ms; "
                "== from-scratch fine/pallas/aligned")
    if stream.metrics.value("stream_enumerations", kind="full") != 1:
        raise AssertionError("the stream enumerated all triangles more than once")
    if counts.fused == 0:
        raise AssertionError("the stream updates never launched fused_level_cuda")
    log(f"phase9 stream: {stream.stats()}; fused_level_cuda launches {counts.fused}")

    # 3. The frozen-lane kernels on real updates' lowered inputs.
    window = bucket_for(stream.graph, chunk=256).window
    err = max(hold_frozen_kernels(torch, held[key], window, key) for key in HELD_UPDATES)
    del held

    # 4. Eight streams' updates coalesce into one dispatch.
    co = Session(max_batch=8, device="cuda")
    streams = [co.open_stream(g, trussness=dec.trussness) for _ in range(8)]
    batches = [balanced_batches(np.random.default_rng(100 + i), g, 16, 1)[0] for i in range(8)]
    before = co.device_dispatches
    t0 = time.perf_counter()
    pend = [s.submit_update(b) for s, b in zip(streams, batches)]
    counts.run(co.flush)
    results = [p.result() for p in pend]
    co_ms = (time.perf_counter() - t0) * 1e3
    if co.device_dispatches != before + 1:
        raise AssertionError(f"8 stream updates made {co.device_dispatches - before} dispatches")
    wants = scratch_trussness(Session(max_batch=8, device="cuda", backend="fine/pallas/aligned"),
                              [s.graph for s in streams])
    for i, (r, w) in enumerate(zip(results, wants)):
        if not np.array_equal(r.trussness, w):
            raise AssertionError(f"coalesced stream {i} != its from-scratch decompose")
    log(f"phase9 8 streams on one Session(max_batch=8): submit_update x 8 + flush = 1 dispatch; "
        f"{co_ms:.1f} ms (8 full enumerations included); frontiers "
        f"{[r.frontier_size for r in results]}; each == from-scratch")
    del streams, pend, results, co

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
    delta, fr, carry = independent_frontier(g1, t1, b2)
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
    log(f"phase10 {tag}: {wall:.2f}s wall; " + ", ".join(
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
    # executor and no kernel (phase 1 built them); the warm repeat builds
    # nothing.
    session = Session(max_batch=8, device="cuda")
    with count_compiles() as cold:
        session.solve(rmat15_queries(g))
    t0 = time.perf_counter()
    with assert_no_compiles("phase 5's batch, warm"):
        again = session.solve(rmat15_queries(g))
    warm = time.perf_counter() - t0
    if (cold.kernel_builds, cold.executor_builds) != (0, 1):
        raise AssertionError(f"phase11 cold run: {cold.kernel_builds} kernel builds, "
                             f"{cold.executor_builds} executor builds (want 0, 1)")
    for name, a, b in zip(QUERIES, again, want):
        if not same_result(name, a, b):
            raise AssertionError(f"phase11 warm repeat: {name} != phase 5's")
    log(f"phase11 sentinel: cold run {cold.kernel_builds} kernel builds, {cold.executor_builds} "
        f"executor build; warm repeat {warm:.2f}s, 0 builds, == phase 5")
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

    from repro_torch.api import Session, TrussQuery
    from repro_torch.configs import BENCH_GRAPHS
    from repro_torch.examples.ktruss_scaling import SETTINGS, sweep
    from repro_torch.examples.tracing import SPANS, traced_solve

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
    session = Session(max_batch=8, device="cuda", trace=str(Path(tmp.name) / "rmat15.json"))
    for run in ("cold", "warm"):
        fused0, support0 = counts.fused, counts.support
        levels0 = session.obs.metrics.value("peel_fused_levels")
        results, _, ms = counts.run(lambda: traced_solve(session, rmat15_queries(g)))
        fused = counts.fused - fused0
        level_steps = int(session.obs.metrics.value("peel_fused_levels") - levels0)
        for name, a, b in zip(QUERIES, results, want):
            if not same_result(name, a, b):
                raise AssertionError(f"phase12 span split ({run}): {name} != phase 5's")
        st = session.stats()
        backends = [c["backend"] for c in st["planner_backends"]]
        if backends != ["fine/fused/aligned"] or st["retries"] or st["backend_fallbacks"]:
            raise AssertionError(f"phase12 span split ({run}): planned on {backends}, "
                                 f"{st['retries']} retries, {st['backend_fallbacks']} fallbacks")
        if not (fused == level_steps == results[0].levels) or counts.support != support0:
            raise AssertionError(
                f"phase12 span split ({run}): {fused} fused launches over {level_steps} level "
                f"steps ({results[0].levels} levels), {counts.support - support0} support "
                f"launches")
        log(f"phase12 rmat-15 span split ({run}): " + ", ".join(
            f"{s} {ms[s]:.2f}" for s in SPANS + ("outside",)) + f" ms; fused_level_cuda "
            f"launches {fused} == level steps == levels; 0 retries, 0 fallbacks; == phase 5")
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
    p, handed = phase_peel_split(torch, g, bucket)
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
    profiled_peel(torch, g, bucket)
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
    if args.mesh_only:
        _, pallas_futs, pallas_wall, _ = phase_pallas_path(torch, g)
        _, fused_futs, _ = phase_fused_main(torch, g, pallas_futs, pallas_wall)
        phase_mesh(torch, g, [f.result() for f in fused_futs], pallas_wall)
        log(smi)
        return 0
    numbers = phase_kernel(torch, g, bucket)
    launches, pallas_futs, pallas_wall, trips = phase_pallas_path(torch, g)
    p, handed = phase_peel_split(torch, g, bucket, trips)
    sets = peel_sets(handed)
    del handed
    phase_peel_sets(torch, p, bucket, sets)
    del p, sets
    phase_paths(torch)
    fused_launches, fused_futs, fused_wall = phase_fused_main(torch, g, pallas_futs, pallas_wall)
    fused_numbers = phase_fused_kernel(torch, g, bucket)
    dense_numbers = phase_dense(torch, g)
    phase_engine(torch, g, pallas_futs, smi)
    stream = phase_stream(torch, g, fused_futs[0].result())
    want = [f.result() for f in fused_futs]
    del fused_futs
    check_phases_clean()
    t10 = time.perf_counter()
    resilience = phase_resilience(torch, g, want, fused_launches)
    phase_fleet(torch, g, want, fused_wall)
    log(f"phase10 {time.perf_counter() - t10:.1f}s")
    mesh = phase_mesh(torch, g, want, pallas_wall)
    examples = phase_examples(torch, g, want)
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
            + examples["support"],
            launches_by_path=dict(
                phase3=launches, phase9=stream["support"], phase10=resilience["support"],
                phase11=mesh["support"], examples=examples["support"],
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
