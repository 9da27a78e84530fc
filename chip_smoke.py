"""GPU smoke test: the overlap pipeline end to end, checked against the plain
reference (fedrann_jax/oracle.py).

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one GPU: phases 1-6
    python chip_smoke.py --four-cards  # four GPUs: the sharded k-NN and
                                       # its one-card reference, nothing else

Phases:
  1. device       the platform must be "gpu"; prints the card, its power
                  limit, the JAX version, XLA_FLAGS, the compile cache and
                  the FASTX parser
  2. main path    an E. coli-scale simulated ONT read set (4.6 Mb genome,
                  50x, 8 kb reads, 5 % error: 28,750 reads, 57,500 rows at
                  d = 512) through fedrann_jax.cli.main, cold then warm;
                  overlaps.tsv checks and ground-truth overlap recall
  3. reference    (a) library bit-exact vs oracle.build_library on a
                  2,000-read subset; (b) embeddings and (c) k-NN of phase 2
                  vs the float64 oracle
  4. golden       parity with the reference-code artifacts in bench/golden
  5. out-of-core  knn_exact_ooc under a budget forcing >= 3 query slabs vs
                  the in-core knn_exact
  6. top-k        lax.top_k on one score tile and the whole knn stage, timed
  7. four cards   (--four-cards only) the main path with the k-NN sharded
                  over four GPUs, ring and allgather, vs knn_exact on one

One process holds the card(s). A failed check fails its phase, phases that
need its output are skipped, and the script exits non-zero without a result
line. On success the last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# The E. coli rung of bench/configs.py and the README's ONT advice.
ECOLI_SIM = dict(genome_length=4_600_000, coverage=50, mean_read_length=8000,
                 error_rate=0.05, seed=1234)
N_NEIGHBORS = 100
ECOLI_ARGS = ["-k", "15", "--kmer-sample-fraction", "0.05",
              "--kmer-min-multiplicity", "2", "-n", "512",
              "--nndescent-n-neighbors", str(N_NEIGHBORS), "--seed", "602"]
LIBRARY_READS = 2000
# The same seed gave recall_ov50 0.9889 and recall_ov75 0.9996 (BASELINE.md).
# Recall is a property of exact search, not of the device.
MIN_RECALL_OV50 = 0.98
MIN_RECALL_OV75 = 0.99
TSV_COLUMNS = ["query_name", "query_orientation", "target_name",
               "target_orientation", "neighbor_rank", "distance"]


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def _cli(argv: list[str]) -> float:
    """Run the CLI in this process; returns its wall seconds."""
    from fedrann_jax import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main exited {rc}: {argv}")
    return wall


def _peak_device_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def _stage_seconds(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "metrics.json")) as f:
        stages = json.load(f)
    return {name: round(e["seconds"], 3) for name, e in stages.items()}


def _row_matches(ids_a: np.ndarray, ids_b: np.ndarray, dist_a, dist_b):
    """Per-row count of ids present in both (R, k) lists, and the absolute
    distance differences of those shared (row, id) pairs. Ids are unique
    within a row."""
    k = ids_a.shape[1]
    ids = np.concatenate([ids_a, ids_b], axis=1)
    dist = np.concatenate([dist_a, dist_b], axis=1).astype(np.float64)
    order = np.argsort(ids, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, axis=1)
    dist = np.take_along_axis(dist, order, axis=1)
    same = ids[:, 1:] == ids[:, :-1]
    diffs = np.abs(dist[:, 1:] - dist[:, :-1])[same]
    return same.sum(axis=1) / k, diffs


def read_overlaps(path: str, name_index: dict) -> tuple[float, np.ndarray]:
    """Checks the header and the column count of overlaps.tsv; returns the
    query coverage (fraction of the 2R (read, orientation) rows that have
    neighbours) and the unordered read-pair keys a*R+b (a < b) it lists."""
    n = len(name_index)
    queries = set()
    qs, ts = [], []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        check(header == TSV_COLUMNS, f"overlaps.tsv header {header}")
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) != 6:
                raise SmokeFailure(f"overlaps.tsv line with {len(cols)} "
                                   f"columns: {line!r}")
            queries.add((cols[0], cols[1]))
            qs.append(name_index[cols[0]])
            ts.append(name_index[cols[2]])
    q, t = np.asarray(qs, np.int64), np.asarray(ts, np.int64)
    keys = np.unique(np.minimum(q, t) * n + np.maximum(q, t))
    return len(queries) / (2 * n), keys


def truth_recall(sim, pair_keys: np.ndarray, min_overlap: int) -> float:
    """Fraction of simulated read pairs overlapping by >= min_overlap bases
    that the output lists in either direction (eval.truth_recall)."""
    n = len(sim.names)
    truth = np.asarray(sorted(a * n + b for a, b in
                              sim.truth_overlaps(min_overlap=min_overlap)),
                       np.int64)
    return float(np.isin(truth, pair_keys).mean()) if len(truth) else 1.0


# --- phases ----------------------------------------------------------------

def phase_device(count: int) -> dict:
    import jax

    from fedrann_jax.io import native
    from fedrann_jax.metrics import device_peaks

    devices = jax.devices()
    dev = devices[0]
    print(f"device: {dev.device_kind} x {len(devices)} ({dev.platform})")
    flops, bw = device_peaks(dev)  # raises for a GPU with no entry
    print(f"published peaks: {flops:.4g} FLOP/s bf16 dense, {bw:.4g} B/s")
    check(len(devices) >= count, f"need {count} devices, have {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")
    print(f"jax {jax.__version__}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    parser = "native" if native.native_available() else "python"
    print(f"FASTX parser: {parser}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def phase_main_path(work: str, sim, cli_args: list[str], read_len: int,
                    min_ov50: float = MIN_RECALL_OV50,
                    min_ov75: float = MIN_RECALL_OV75) -> dict:
    """Cold and warm CLI runs on the simulated reads. The cold run keeps its
    intermediates, which hold the library and embedding matrix the later
    phases compare with the reference. Truth pairs overlap by at least a
    half / three quarters of the simulated mean read length (read_len), as
    bench/run.py counts them."""
    from fedrann_jax.sim import write_fasta

    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    out = os.path.join(work, "out")
    base = ["-i", fasta, "-o", out, *cli_args]
    walls = {}
    for run, extra in (("cold", ["--keep-intermediates"]), ("warm", [])):
        walls[run] = _cli(base + extra)
        print(f"main path {run}: wall {walls[run]:.3f} s, stages "
              f"{_stage_seconds(out)}, process peak device memory "
              f"{_peak_device_bytes()} B")
    with open(os.path.join(out, "metrics.json")) as f:
        print(f"main path load parser (warm): "
              f"{json.load(f)['load'].get('parser')}")
    name_index = {name: i for i, name in enumerate(sim.names)}
    coverage, keys = read_overlaps(os.path.join(out, "overlaps.tsv"),
                                   name_index)
    ov50 = truth_recall(sim, keys, read_len // 2)
    ov75 = truth_recall(sim, keys, read_len * 3 // 4)
    print(f"main path: {len(sim.names)} reads, query coverage {coverage}, "
          f"recall_ov50 {ov50:.4f}, recall_ov75 {ov75:.4f}")
    check(coverage == 1.0, f"query coverage {coverage}")
    check(ov50 >= min_ov50, f"recall_ov50 {ov50:.4f} < {min_ov50}")
    check(ov75 >= min_ov75, f"recall_ov75 {ov75:.4f} < {min_ov75}")
    from fedrann_jax.oracle import KmerLibrary

    ckpt = os.path.join(out, "checkpoints")
    lib = np.load(os.path.join(ckpt, "library.npz"))
    return {
        "library": KmerLibrary(codes=lib["codes"], counts=lib["counts"]),
        "embeddings": np.load(os.path.join(ckpt, "embeddings.npy")),
        "walls": walls,
    }


def phase_library(work: str, sim, n_reads: int, cli_args: list[str]) -> None:
    """The device library of an n_reads subset equals the oracle's bit for
    bit: codec, sort, count, multiplicity filter, sampling, compaction."""
    from fedrann_jax import oracle
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import write_fasta

    names, seqs = sim.names[:n_reads], sim.sequences[:n_reads]
    fasta = os.path.join(work, "subset.fasta")
    write_fasta(fasta, names, seqs)
    config = config_from_args(
        ["-i", fasta, "-o", os.path.join(work, "subset_out"), *cli_args])
    lib = run_pipeline(config).library
    ref = oracle.build_library(seqs, config.kmer_size,
                               config.kmer_min_multiplicity,
                               config.kmer_sample_fraction, config.seed)
    print(f"library: {lib.size} device k-mers, {ref.size} oracle k-mers")
    check(ref.size > 0, "oracle library is empty")
    check(np.array_equal(lib.codes, ref.codes), "library codes differ")
    check(np.array_equal(lib.counts, ref.counts), "library counts differ")


def phase_embeddings(sim, main: dict, cli_args: list[str],
                     n_reads: int = 256, seed: int = 0) -> None:
    """Device rows of n_reads sampled reads vs oracle.feature_rows +
    srp + embed summed in float64, against phase 2's own library. Bound:
    row cosine >= 0.9999 — the device sums the same f32 terms in another
    order (f32 rounding, ~1e-7 relative per add)."""
    from fedrann_jax import oracle
    from fedrann_jax.cli import config_from_args

    config = config_from_args(["-i", "-", "-o", "-", *cli_args])
    emb, library = main["embeddings"], main["library"]
    reads = np.sort(np.random.default_rng(seed).choice(
        len(sim.names), size=min(n_reads, len(sim.names)), replace=False))
    rows = oracle.feature_rows([sim.sequences[i] for i in reads],
                               config.kmer_size, library)
    ref = oracle.embed(rows, library, emb.shape[1], config.projection_seed,
                       config.projection_density, dtype=np.float64)
    dev = emb[np.stack([2 * reads, 2 * reads + 1], axis=1).ravel()]
    dev = dev.astype(np.float64)
    n_ref, n_dev = np.linalg.norm(ref, axis=1), np.linalg.norm(dev, axis=1)
    zero = (n_ref == 0) | (n_dev == 0)
    check(np.array_equal(n_ref == 0, n_dev == 0), "zero rows differ")
    cos = (ref[~zero] * dev[~zero]).sum(1) / (n_ref[~zero] * n_dev[~zero])
    print(f"embeddings: {len(cos)} rows, min cosine {cos.min():.8f}, "
          f"{int(zero.sum())} zero rows")
    check(cos.min() >= 0.9999, f"embedding cosine {cos.min():.8f} < 0.9999")


def phase_knn_reference(emb: np.ndarray, k: int, n_queries: int = 512,
                        seed: int = 0) -> None:
    """Exact top-k of n_queries sampled rows in float64 numpy vs the device
    k-NN over the whole matrix.
    - bf16 (bf16 operands, f32 accumulation, u16 distance wire — the CLI
      default): recall >= 0.99 and distance MAE < 5e-3, the golden-parity
      bounds (tests/test_golden_parity.py).
    - fp32 (Precision.HIGHEST, f32 wire): recall >= 0.999 and max distance
      error <= 1e-5; f32 rounding of a 512-term dot of unit rows stays
      near 1e-6."""
    from fedrann_jax.knn.topk import knn_exact

    e = emb.astype(np.float64)
    norms = np.linalg.norm(e, axis=1, keepdims=True)
    en = e / np.where(norms == 0, 1.0, norms)
    q = np.sort(np.random.default_rng(seed).choice(
        len(en), size=min(n_queries, len(en)), replace=False))
    d64 = 1.0 - en[q] @ en.T
    k = min(k, len(en))
    ref = np.argsort(d64, axis=1, kind="stable")[:, :k]
    kth = np.take_along_axis(d64, ref[:, -1:], axis=1)
    bounds = {"bf16": ("u16", 0.99, "mae", 5e-3),
              "fp32": ("f32", 0.999, "max", 1e-5)}
    failures = []
    for precision, (transfer, min_recall, stat, tol) in bounds.items():
        idx, dist = knn_exact(emb, k, precision=precision, transfer=transfer)
        idx, dist = idx[q], dist[q]
        recall, _ = _row_matches(idx, ref, dist, dist)
        true = np.take_along_axis(d64, idx, axis=1)
        err = np.abs(dist - true)
        # misses are ids past the exact k-th distance; how far past says
        # whether they are boundary swaps at the path's precision
        past = (true - kth)[true > kth]
        value = err.mean() if stat == "mae" else err.max()
        print(f"knn {precision}: recall {recall.mean():.6f}, distance MAE "
              f"{err.mean():.3e}, max error {err.max():.3e}, "
              f"{len(past)} misses, max past the k-th distance "
              f"{past.max() if len(past) else 0.0:.3e}")
        if recall.mean() < min_recall or value > tol:
            failures.append(f"{precision}: recall {recall.mean():.6f} "
                            f"(>= {min_recall}), {stat} {value:.3e} "
                            f"(<= {tol})")
    check(not failures, "; ".join(failures))


def phase_golden(work: str) -> None:
    """Both golden sets through the CLI with the reference run's library
    and projection: query coverage 1.0, neighbour recall@20 >= 0.99,
    distance MAE < 5e-3, row cosine > 0.999 (tests/test_golden_parity.py)."""
    from fedrann_jax.eval import OverlapTable, neighbor_recall

    for name in ("data", "data_k21"):
        data = os.path.join(ROOT, "bench", "golden", name)
        k = 15
        meta = os.path.join(data, "meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                k = int(json.load(f)["k"])
        out = os.path.join(work, f"golden_{name}")
        _cli(["-i", os.path.join(data, "reads.fasta.gz"), "-o", out,
              "-k", str(k),
              "--import-library", os.path.join(data, "fwd_kmer_library.fasta"),
              "--import-projection", os.path.join(data, "precompute.npz"),
              "--nndescent-n-neighbors", "20", "--seed", "20260817",
              "--save-feature-matrix"])
        rep = neighbor_recall(
            OverlapTable.read(os.path.join(data, "overlaps_ref.tsv")),
            OverlapTable.read(os.path.join(out, "overlaps.tsv")), k=20)
        fm = np.load(os.path.join(out, "feature_matrix.npz"))
        ours, names = fm["embeddings"].astype(np.float64), list(fm["names"])
        ref_emb = np.load(os.path.join(data, "ref_embeddings.npy"))
        with open(os.path.join(data, "ref_row_names.txt")) as f:
            ref_names = [ln.rstrip("\n") for ln in f]
        ref_row = {(ref_names[i], i % 2): i for i in range(len(ref_names))}
        sims = []
        for r, read in enumerate(names):
            for strand in (0, 1):
                a, b = ours[2 * r + strand], ref_emb[ref_row[(read, strand)]]
                na, nb = np.linalg.norm(a), np.linalg.norm(b)
                check((na == 0) == (nb == 0), f"{name}: zero rows differ")
                if na:
                    sims.append(float(a @ b / (na * nb)))
        print(f"golden {name} (k={k}): {rep}, min row cosine "
              f"{min(sims):.6f}")
        check(rep.query_coverage == 1.0, f"{name}: coverage {rep}")
        check(rep.recall_at_k >= 0.99, f"{name}: recall {rep}")
        check(rep.distance_mae < 5e-3, f"{name}: distance MAE {rep}")
        check(min(sims) > 0.999, f"{name}: row cosine {min(sims)}")


def phase_ooc(emb: np.ndarray, k: int, min_slabs: int = 3,
              query_tile: int = 512) -> None:
    """knn_exact_ooc streams a host-resident matrix through a budget that
    forces >= min_slabs query slabs; it must equal the in-core knn_exact:
    recall >= 0.999 and shared-pair distances within 1e-3. Both search bf16
    operands; the out-of-core path normalizes on the host, so an operand
    may round to the neighbouring bf16 value (one bf16 step of a
    unit-row entry moves a distance by ~1e-5), plus 1.5e-5 of u16 wire
    rounding on each side."""
    from fedrann_jax.knn.ooc import knn_exact_ooc, plan_ooc
    from fedrann_jax.knn.topk import knn_exact

    n, d = emb.shape
    k = min(k, n)
    budget = 1 << 30
    while True:
        q_rows, c_rows = plan_ooc(n, d, k, budget, query_tile)
        n_slabs = -(-n // q_rows)
        if n_slabs >= min_slabs or budget <= 1 << 16:
            break
        budget //= 2
    check(n_slabs >= min_slabs, f"no budget gives {min_slabs} slabs")
    t0 = time.perf_counter()
    idx_o, dist_o = knn_exact_ooc(emb, k, hbm_budget=budget,
                                  query_tile=query_tile, transfer="u16")
    wall = time.perf_counter() - t0
    idx_i, dist_i = knn_exact(emb, k, query_tile=query_tile, transfer="u16")
    recall, diffs = _row_matches(idx_o, idx_i, dist_o, dist_i)
    print(f"out-of-core: budget {budget} B -> {n_slabs} query slabs of "
          f"{q_rows} rows, {-(-n // c_rows)} candidate blocks of {c_rows} "
          f"rows, {wall:.3f} s; recall vs in-core {recall.mean():.6f}, "
          f"max shared-pair distance difference {diffs.max():.3e}")
    check(recall.mean() >= 0.999, f"ooc recall {recall.mean():.6f}")
    check(diffs.max() <= 1e-3, f"ooc distance difference {diffs.max():.3e}")


def _median_time(fn, reps: int) -> tuple[float, list[float]]:
    """Median wall of fn() after one warm-up call; fn blocks on its result."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def phase_topk(emb: np.ndarray, k: int, tile=(512, 131072),
               big_rows: int = 120_000, reps: int = 3) -> None:
    """Timings: lax.top_k on one f32 score tile (config's knn_query_tile x
    knn_candidate_tile), and the whole knn stage (knn_exact with the CLI's
    u16 wire) at phase 2's matrix and at big_rows random unit rows (the
    dmel rung's shape), each after a warm-up."""
    import jax
    import jax.numpy as jnp

    from fedrann_jax.knn.topk import knn_exact

    scores = jax.random.normal(jax.random.key(0), tile, jnp.float32)
    top_k = jax.jit(lambda s: jax.lax.top_k(s, k))
    med, times = _median_time(
        lambda: jax.block_until_ready(top_k(scores)), reps)
    print(f"top-k lax.top_k on {tile} f32, k={k}: median {med * 1e3:.3f} ms "
          f"of {[round(t * 1e3, 3) for t in times]}")
    big = jax.random.normal(jax.random.key(1), (big_rows, emb.shape[1]),
                            jnp.float32)
    big = big / jnp.linalg.norm(big, axis=1, keepdims=True)
    for shape_name, e in (("main path", emb), ("random unit", big)):
        med, times = _median_time(
            lambda: knn_exact(e, k, transfer="u16"), reps)
        print(f"knn stage {shape_name} {tuple(e.shape)}: median {med:.4f} s "
              f"of {[round(t, 4) for t in times]}")


def phase_four_cards(work: str, sim, cli_args: list[str],
                     n_devices: int = 4) -> None:
    """The main path with the k-NN sharded over n_devices on a flat 1-D
    "data" mesh, ring then allgather, each vs knn_exact on one card over the
    same embeddings: recall >= 0.999 and shared-pair distances within 1e-3
    (same bf16 operands; row normalization may fuse differently inside the
    sharded program, moving an operand by one bf16 step)."""
    import jax

    from fedrann_jax.cli import config_from_args
    from fedrann_jax.knn.topk import knn_exact
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import write_fasta

    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, have {len(jax.devices())}")
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    failures = []
    for strategy in ("ring", "allgather"):
        config = config_from_args(
            ["-i", fasta, "-o", os.path.join(work, "out"), *cli_args,
             "--knn-sharded", "always", "--knn-shard-strategy", strategy,
             "--mesh-shape", str(n_devices)])
        t0 = time.perf_counter()
        result = run_pipeline(config)
        wall = time.perf_counter() - t0
        idx_1, dist_1 = knn_exact(result.embeddings, config.n_neighbors,
                                  transfer=config.knn_transfer)
        recall, diffs = _row_matches(result.neighbor_indices, idx_1,
                                     result.neighbor_distances, dist_1)
        stages = {s: round(e["seconds"], 3)
                  for s, e in result.metrics.items()}
        print(f"{n_devices} cards {strategy}: wall {wall:.3f} s, stages "
              f"{stages}, "
              f"recall vs one card {recall.mean():.6f}, max shared-pair "
              f"distance difference {diffs.max():.3e}")
        if recall.mean() < 0.999 or diffs.max() > 1e-3:
            failures.append(f"{strategy}: recall {recall.mean():.6f}, "
                            f"distance difference {diffs.max():.3e}")
    check(not failures, "; ".join(failures))


# --- driver ----------------------------------------------------------------

def run_phases(four_cards: bool) -> tuple[dict | None, list[str]]:
    """Runs the phases in order; returns (device info, failures). A phase
    that fails is recorded and the phases that need its output are
    skipped; independent phases still run."""
    failures: list[str] = []

    def phase(name, fn, *a, **kw):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*a, **kw)
        except Exception as e:  # record, go on with independent phases
            traceback.print_exc()
            failures.append(f"{name}: {e}")
            print(f"== {name}: FAILED: {e}", flush=True)
            return None
        print(f"== {name}: ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    def needs(name, dep):
        if dep is None:
            failures.append(f"{name}: skipped, its input phase failed")
            print(f"== {name}: SKIPPED (input phase failed)", flush=True)
            return False
        return True

    info = phase("1 device", phase_device, 4 if four_cards else 1)
    if info is None:
        return None, failures
    from fedrann_jax.sim import simulate_reads

    t0 = time.perf_counter()
    sim = simulate_reads(**ECOLI_SIM)
    print(f"simulated {len(sim.names)} reads in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if four_cards:
            phase("7 four cards", phase_four_cards, work, sim, ECOLI_ARGS, 4)
            return info, failures
        main_out = phase("2 main path", phase_main_path, work, sim,
                         ECOLI_ARGS, ECOLI_SIM["mean_read_length"])
        phase("3a library", phase_library, work, sim, LIBRARY_READS,
              ECOLI_ARGS)
        if needs("3b embeddings", main_out):
            phase("3b embeddings", phase_embeddings, sim, main_out,
                  ECOLI_ARGS)
        if needs("3c knn", main_out):
            phase("3c knn", phase_knn_reference, main_out["embeddings"],
                  N_NEIGHBORS)
        phase("4 golden", phase_golden, work)
        if needs("5 out-of-core", main_out):
            phase("5 out-of-core", phase_ooc, main_out["embeddings"],
                  N_NEIGHBORS)
        if needs("6 top-k", main_out):
            phase("6 top-k", phase_topk, main_out["embeddings"], N_NEIGHBORS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return info, failures


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded k-NN on four GPUs and its "
                        "one-card reference")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    info, failures = run_phases(args.four_cards)
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
