#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. setup: the card's name and power limit; build the hand-written support
   kernel from ``src/repro_torch/kernels/csrc`` and print nvcc's
   register/spill report.
2. kernel vs plain version, at the main path's input: ``rmat-15``
   (``configs.LARGE_GRAPHS``) packed as phase 3 packs it (8 slots of its
   bucket, 3 live); ``support_fine_cuda`` must equal the plain torch
   ``support_fine_owner`` bit for bit on the full alive mask and three
   seeded random masks.  Times the kernel, the plain version and a
   ``torch.sparse`` yardstick; computes the kernel's bound.
3. main path, full size: ``decompose``/``kmax``/``ktruss(k=4)`` of
   ``rmat-15`` through ``Session.solve`` on CUDA with the backend left to
   the auto rule; checks the backend, one dispatch, that the kernel ran
   once per peel trip, and the results against each other and the numpy
   oracle.
4. main path vs the torch-ops path and the oracle: every
   ``configs.BENCH_GRAPHS`` graph decomposed through
   ``fine/pallas/aligned`` and ``fine/xla/aligned``; trussness must agree
   bit for bit, and equal ``trussness_numpy`` on er-4k and clustered-32x40.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches on the main path and its times.
Imports nothing of JAX or of the JAX package.  Needs one CUDA card; exits
non-zero without one, or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor peak, the table's float32 row
SEED_MASKS = (101, 202, 303)


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


def support_bound(p, alive) -> tuple[float, str, float, float]:
    """Least time for ``support_fine`` on these inputs: bytes (each input
    read once, the output written once) over the memory rate vs the
    intersection steps these rows need (per alive edge the cheaper of a
    merge, deg(a)+deg(b), and a binary search of the shorter row in the
    longer, min*ceil(log2(max+1))) over the non-tensor peak."""
    import torch

    nbytes = (
        p.edge_row.numel() * 4 + p.colidx.numel() * 4 + alive.numel() * 1
        + p.urowptr.numel() * 4 + p.udeg.numel() * 4
        + p.ucolidx.numel() * 4 + p.u2d.numel() * 4
        + p.colidx.numel() * 4  # the (nnz_pad,) int32 output
    )
    live = (p.colidx != 0) & alive
    da = p.udeg[p.edge_row[live].long()].double()
    db = p.udeg[p.colidx[live].long()].double()
    lo, hi = torch.minimum(da, db), torch.maximum(da, db)
    ops = float(torch.minimum(da + db, lo * torch.ceil(torch.log2(hi + 1))).sum())
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


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
    from repro_torch.kernels.support_fine import load_support_fine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = load_support_fine()
    log(f"phase1 build support_fine: {time.perf_counter() - t0:.2f}s (nvcc {built.build_s:.2f}s) -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return smi


def main_path_problem(g, bucket, slots):
    from repro_torch.graphs import pack_problems

    return pack_problems(
        [g, g, g], slot_n=bucket.n_pad, slot_nnz=bucket.nnz_pad, slots=slots,
        chunk=256, layout="aligned", device="cuda",
    ).problem


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
        got = support_fine_cuda(p, m)
        want = plain(m)
        torch.cuda.synchronize()
        e = int((got.long() - want.long()).abs().max())
        log(f"phase2 mask {i}: alive={int(m.sum())} max_abs_err={e} sum={int(got.long().sum())}")
        if e or not torch.equal(got, want):
            raise AssertionError(f"support_fine_cuda disagrees with its plain version on mask {i}")
        err = max(err, e)
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


def phase_main(torch, g) -> int:
    from repro_torch.api import Session, TrussQuery
    from repro_torch.core import support_numpy
    from repro_torch.kernels import support_fine_cuda

    session = Session(device="cuda")
    queries = [TrussQuery.decompose(g), TrussQuery.kmax(g), TrussQuery.ktruss(g, k=4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    support_fine_cuda.launches = 0
    t0 = time.perf_counter()
    futs = [session.submit(q) for q in queries]
    session.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = support_fine_cuda.launches
    dec, kmax, kt = (f.result() for f in futs)

    st = session.stats()
    backends = {row["backend"] for row in st["planner_backends"]}
    trips = futs[0].stats.dispatch_trips
    log(
        f"phase3 rmat-15 solve: {wall:.2f}s wall, backend {sorted(backends)}, dispatches "
        f"{st['device_dispatches']}, total_iters {trips}, launches {launches}, levels {dec.levels}, "
        f"kmax {dec.kmax}, ktruss(4) edges {kt.edges_remaining}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    if backends != {"fine/pallas/aligned"}:
        raise AssertionError(f"planner chose {backends}, expected fine/pallas/aligned")
    if st["device_dispatches"] != 1:
        raise AssertionError(f"{st['device_dispatches']} dispatches for one bucket")
    if launches != trips or trips == 0:
        raise AssertionError(f"kernel launched {launches} times over {trips} peel trips")
    if kmax != (dec.kmax if dec.kmax >= 3 else 0):
        raise AssertionError(f"kmax query {kmax} != decompose kmax {dec.kmax}")
    if not (kt.alive == (dec.trussness >= 4)).all():
        raise AssertionError("ktruss(4) mask != (trussness >= 4)")
    s = support_numpy(g, kt.alive)
    if not (s[kt.alive] >= 2).all():
        raise AssertionError("a 4-truss edge has support < 2 under the numpy oracle")
    return launches


def phase_paths(torch) -> None:
    from repro_torch.api import Session, TrussQuery
    from repro_torch.configs import BENCH_GRAPHS
    from repro_torch.core import trussness_numpy

    graphs = [b.build() for b in BENCH_GRAPHS]
    out = {}
    for backend in ("fine/pallas/aligned", "fine/xla/aligned"):
        session = Session(max_batch=8, device="cuda", backend=backend)
        t0 = time.perf_counter()
        out[backend] = session.solve([TrussQuery.decompose(g) for g in graphs])
        torch.cuda.synchronize()
        log(f"phase4 {backend}: {time.perf_counter() - t0:.2f}s, dispatches {session.device_dispatches}")
    for g, a, b in zip(graphs, out["fine/pallas/aligned"], out["fine/xla/aligned"]):
        if not (a.trussness == b.trussness).all() or (a.kmax, a.levels) != (b.kmax, b.levels):
            raise AssertionError(f"{g.name}: kernel path and torch-ops path disagree")
        log(f"phase4 {g.name}: n={g.n} nnz={g.nnz} kmax={a.kmax} levels={a.levels} agree")
        if g.name in ("er-4k", "clustered-32x40"):
            if not (a.trussness == trussness_numpy(g)).all():
                raise AssertionError(f"{g.name}: trussness != numpy oracle")
            log(f"phase4 {g.name}: equals trussness_numpy")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import bucket_for
    from repro_torch.configs import LARGE_GRAPHS

    t_start = time.perf_counter()
    smi = phase_setup(torch)
    g = next(b for b in LARGE_GRAPHS if b.name == "rmat-15").build()
    bucket = bucket_for(g, chunk=256)
    log(f"rmat-15: n={g.n} nnz={g.nnz} bucket={tuple(bucket)}")
    numbers = phase_kernel(torch, g, bucket)
    launches = phase_main(torch, g)
    phase_paths(torch)
    kernels = [dict(
        name="support_fine_cuda",
        route="cuda",
        source="src/repro_torch/kernels/csrc/support_fine.cu",
        replaces="src/repro/kernels/support_fine.py:86",
        launches=launches,
        **numbers,
    )]
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
    sys.exit(main())
