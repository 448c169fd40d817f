"""A configuration's graph generator and a mix's driver found by file, on
the CPU at tiny sizes: a cell that uses both, added as files alone; the
error for a name with no file; the existing cells' inputs, pinned; and the
eight-client cell's driver, its counts and its faults."""

import hashlib
import json
import random
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
from test_ktb_harness import ALTERED, _imports
from tiny import run_cell, tiny_copy

from ktbench import check, control, generators
from ktbench.clients import Records, make_driver
from ktbench.spec import HERE, load_reader

TINY = json.loads((HERE / "configs" / "graph500-s18.json").read_text())
TINY.update(name="tiny-rmat", scale=8, edge_factor=4)  # tiny.py's tiny-rmat
C8 = json.loads((HERE / "traffic" / "decompose_alt2_c8.json").read_text())

GRID = '''"""A square grid with both diagonals of every cell, its vertices
relabeled at random: every inner edge lies on triangles."""

import torch

from ktbench.generators import canonical, derived_seed


def graph(config, seed, index, device):
    side = config["side"]
    n = side * side
    ids = torch.arange(n, device=device).reshape(side, side)
    pairs = [(ids[:, :-1], ids[:, 1:]), (ids[:-1, :], ids[1:, :]),
             (ids[:-1, :-1], ids[1:, 1:]), (ids[:-1, 1:], ids[1:, :-1])]
    edges = torch.cat([torch.stack([a.reshape(-1), b.reshape(-1)], 1) for a, b in pairs])
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, index))
    perm = torch.randperm(n, generator=gen, device=device)
    return n, canonical(n, perm[edges])
'''

REVERSED = '''"""One closed-loop client that visits the pool from its last graph down."""

from ktbench import clients


class Reversed(clients.DecomposeDriver):
    def graph_of(self, j):
        return len(self.pool) - 1 - j % len(self.pool)


def make_driver(config, traffic, seed, device):
    return Reversed(config, traffic, seed, device)
'''


def _add_grid_cell(root):
    """A generator, a driver, a configuration, a mix and a cell, added as
    new files and entries; returns the bytes of every file that was there."""
    kt = root / "ktbench"
    before = {p: p.read_bytes() for p in kt.rglob("*") if p.is_file()}
    (kt / "graph_generators").mkdir(exist_ok=True)
    (kt / "drivers").mkdir(exist_ok=True)
    (kt / "graph_generators" / "tiny_grid.py").write_text(GRID)
    (kt / "drivers" / "decompose_reversed.py").write_text(REVERSED)
    (kt / "configs" / "tiny-grid.json").write_text(json.dumps(
        {"name": "tiny-grid", "generator": "tiny_grid", "side": 9}))
    (kt / "traffic" / "decompose_rev.json").write_text(json.dumps(
        {"kind": "decompose_reversed", "max_batch": 2, "pool": 3, "check_sample": 4,
         "profile_requests": 1}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-grid", "source": "test", "file": "ktbench/configs/tiny-grid.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "grid_rev", "config": "tiny-grid", "traffic": "decompose_rev",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "g500_decompose" in m.get("workloads", ()):
            m["workloads"].append("grid_rev")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return before


@pytest.mark.parametrize("trace", [0, 1])
def test_a_generator_and_a_driver_added_as_files_run_a_cell(tmp_path, trace):
    root = tiny_copy(tmp_path)
    before = _add_grid_cell(root)
    assert all(p.read_bytes() == b for p, b in before.items())
    tops = {n.split(".")[0] for n in _imports(root / "ktbench" / "graph_generators" / "tiny_grid.py")}
    assert not tops & {"repro_torch", "repro", "jax"}

    rc, result, err = run_cell(root, "grid_rev", trace=trace)
    assert rc == 0, err
    assert result["correct"], err
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["value"] == 0 for v in result["checks"].values())
    if trace:
        assert "dispatch_ms" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"edges_per_s", "setup_s"}


def test_a_generator_file_draws_from_the_seed_and_index(tmp_path):
    root = tiny_copy(tmp_path)
    _add_grid_cell(root)
    code = (f"import sys; sys.path.insert(0, {str(root)!r})\n"
            "import hashlib, json\n"
            "from ktbench import generators\n"
            "c = {'generator': 'tiny_grid', 'side': 9}\n"
            "g = [generators.config_graph(c, s, i) for s, i in ((5, 0), (5, 0), (5, 1), (6, 0))]\n"
            "print(json.dumps([[n, e.shape[0], hashlib.sha256(e.tobytes()).hexdigest()] for n, e in g]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    g = json.loads(out.stdout)
    assert g[0] == g[1] and g[0] != g[2] and g[0] != g[3]
    assert g[0][:2] == [81, 2 * 9 * 8 + 2 * 8 * 8]


@pytest.mark.parametrize("what", ["generator", "traffic kind"])
def test_an_unknown_name_raises_naming_the_path(what):
    if what == "generator":
        with pytest.raises(ValueError, match=r"graph_generators/no_such\.py"):
            generators.config_graph(dict(TINY, generator="no_such"), 1, 0)
    else:
        with pytest.raises(ValueError, match=r"drivers/no_such\.py"):
            make_driver(TINY, dict(C8, kind="no_such"), 1, "cpu")


# The existing cells' inputs, hashed on the parent of the change that
# added the lookups by file: the graphs of tiny-rmat and the stream mix's
# updates.
GRAPHS = {
    (11, 0): "a594a08a5176671d940e980a907697bc8bb8ccba15cd59c418c0dbd74d02d580",
    (11, 1): "d595330dd14d94ba79df884a9b20483142439bfcd979c42f96edee990fa61a24",
    (2_147_483_659, 0): "1bdc238860f79e281c0ecc282f1b6091d312e93a60a2cdc9caa915a4c1805507",
    (2_147_483_659, 1): "7dee2e2d8c0b0e334097e05e0e5833515616f1742fd087f9a9e027e80310ec2f",
}
UPDATES = {
    11: "7581a1596228d7bc33d9941d8a8b705706147f188b95e5f8cf08765482f83cee",
    2_147_483_659: "341cd48a181f04cc8fb84783f83c2a3c5dd068e39fa53b51b66735dd87195b7c",
}


@pytest.mark.parametrize("seed, index", sorted(GRAPHS))
def test_the_rmat_graphs_are_unchanged(seed, index):
    _, edges = generators.config_graph(TINY, seed, index)
    assert hashlib.sha256(np.ascontiguousarray(edges, np.int64).tobytes()).hexdigest() == GRAPHS[seed, index]


@pytest.mark.parametrize("seed", sorted(UPDATES))
def test_the_stream_updates_are_unchanged(seed):
    traffic = json.loads((HERE / "traffic" / "stream_w1.json").read_text())
    driver = make_driver(TINY, traffic, seed, "cpu")
    h = hashlib.sha256()
    for batch in driver.batches:
        for a in batch:
            a = np.ascontiguousarray(a, np.int64)
            h.update(np.asarray(a.shape, np.int64).tobytes())
            h.update(a.tobytes())
    assert h.hexdigest() == UPDATES[seed]


# The eight-client cell's own per-layer metrics, as entries for the tiny
# cell (the scale-18 cell is not in BENCHMARK.json: its runs spread too
# widely for the bound of edges_per_s).
C8_METRICS = [
    ("queries_per_dispatch.c8", "queries", "higher", "program_counter", "api"),
    ("dispatch_device_ms.c8", "ms", "lower", "program_counter", "peel"),
    ("fused_trip_us.c8", "us", "lower", "program_counter", "kernels"),
    ("fused_level_roofline_pct.c8", "%", "higher", "device_trace", "kernels"),
    ("device_idle_pct.c8", "%", "lower", "device_trace", "device"),
]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_eight_client_cell_runs_correct(tmp_path, trace):
    root = tiny_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] += [{"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
                            "moves": "edges_per_s", "workloads": ["t_c8"]}
                           for name, unit, better, source, layer in C8_METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, result, err = run_cell(root, "t_c8", trace=trace)
    assert rc == 0, err
    assert result["correct"], err
    assert result["attempted"] >= C8["clients"] and result["failed"] == 0
    assert all(v["limit"] == 0 and v["value"] == 0 for v in result["checks"].values())
    assert "window batches by size" in err
    if trace:
        # Off the card the device readers find nothing to read.
        assert result["metrics"]["queries_per_dispatch.c8"]["value"] >= 1.0
        assert "dispatch_device_ms.c8" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"edges_per_s", "setup_s"}


def test_the_eight_client_cell_with_an_altered_answer_is_not_correct(tmp_path):
    root = tiny_copy(tmp_path)
    rc, result, err = run_cell(root, "t_c8", prelude=ALTERED, seconds=1.5)
    assert rc == 0, err
    assert result["correct"] is False, err
    assert result["checks"]["mismatched_edges"]["value"] > 0


def _c8_driver(**traffic):
    from repro_torch.api import Session

    driver = make_driver(TINY, dict(C8, **traffic), 2_147_483_659, "cpu")
    driver.open(Session(device="cpu", max_batch=C8["max_batch"], faults=None))
    return driver


def test_the_warm_round_is_one_dispatch_of_every_client():
    driver = _c8_driver()
    driver.warm()
    s = driver.session
    assert s.batches_run == C8["pool"] + 1
    assert s.requests_served == C8["pool"] + C8["clients"]


def test_queries_per_dispatch_counts_the_runs_batches():
    driver = _c8_driver()
    rec = Records(sample=4, rng=random.Random(3))
    reader = load_reader("layer_metrics", "queries_per_dispatch.c8")
    assert reader.read(SimpleNamespace(driver=driver)) is None  # no run yet
    driver.warm()
    driver.run(rec, requests=C8["clients"])
    assert rec.attempted == C8["clients"] and rec.failed == 0
    batches = sum(1 / k for k in driver.batch_sizes)
    assert reader.read(SimpleNamespace(driver=driver)) == pytest.approx(C8["clients"] / batches)
    assert driver.summary()[0].startswith("batches by size (from 8 requests)")


class _Instant:
    """A session that answers at once: the clients' lock alone is tested."""

    def __init__(self):
        self.requests_served = self.batches_run = 0
        self._lock = threading.Lock()

    def submit(self, query):
        with self._lock:
            self.requests_served += 1
            self.batches_run += 1
        res = SimpleNamespace(kmax=2, trussness=np.zeros(0, np.int32))
        return SimpleNamespace(result=lambda timeout=None: res, stats=SimpleNamespace(batch_size=1))


def test_the_clients_lose_no_update_under_contention():
    driver = make_driver(TINY, dict(C8, clients=32), 5, "cpu")
    driver.open(_Instant())
    rec = Records(sample=8, rng=random.Random(1))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        driver.run(rec, requests=3000)
    finally:
        sys.setswitchinterval(interval)
    assert driver.requests == 3000 and rec.attempted == 3000 and rec.failed == 0
    assert len(rec.answers) == len(rec.latencies) == len(driver.batch_sizes) == 3000
    assert sorted(a.index for a in rec.answers) == list(range(3000))
    per_graph = np.bincount([a.graph for a in rec.answers], minlength=2)
    assert per_graph.tolist() == [1500, 1500]
    assert rec.work == sum(int(c) * driver.pool[g][1].shape[0] for g, c in enumerate(per_graph))
    assert driver.served == driver.batches == 3000
    assert len(rec.kept) == 8


@pytest.mark.parametrize("seed", [11, 2_147_483_701, 4_000_000_007])
def test_the_control_is_not_correct_on_the_eight_client_mix(seed):
    driver = make_driver(TINY, C8, seed, "cpu")
    rec = control.control_records(driver, 24, seed, "cpu")
    readings, _ = check.compare(driver, rec, "cpu")
    assert not check.verdict(readings)
    assert readings["mismatched_edges"] > 0

