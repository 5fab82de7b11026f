#!/usr/bin/env python3
"""Prove that the engine runs on an NVIDIA GPU, through its normal entry
points, at a real corpus size.

    python chip_smoke.py                 # one GPU: phases 1-5
    python chip_smoke.py --chips 4       # four GPUs: the word-sharded path

Phases (one GPU):
  1. identity  — JAX must find a GPU; prints the card, nvidia-smi's name and
                 power limit, the JAX version and the compile cache, and
                 builds the CUDA filter VM (native/silo_vm.cu).
  2. ingest    — `cli --preprocessing` on a seeded FASTA + TSV corpus of
                 4,096 genomes x 29,903 positions.
  3. kernels   — synthetic_database(1,048,576 x 29,903, 8 partitions) from
                 --seed (a ~11.8 GB dense bank): every executable of the path
                 compiled with its memory_analysis() printed and compared
                 bit for bit with its plain reference (VM kernel vs the XLA
                 VM; dense and sparse Mutations, densify and group-by vs
                 numpy); then the VM kernel timed against the XLA VM.
  4. serve     — the same corpus saved as a snapshot and served by
                 `cli --api`; every /query answer must equal the host-only
                 engine's (QueryEngine(use_device=False)) JSON.
  5. two-tier  — phase 4 again with SILO_DENSE_BANK_BUDGET_GB=4: the sparse
                 tier and the hot-leaf pool must be active, with pool hits
                 on a repeated batch.
With --chips 4 only the mesh path runs: phase 4's queries through `--api`
sharded over all four cards, and a mesh DeviceEngine against a one-card
engine and the host oracle.

The parent process never starts a JAX GPU backend: each phase that uses a
card is a child process, run one after another. The last line of stdout is
{"ok": true, "device": {"platform", "kind", "count"}}; it is printed only
when every phase passed. Exit status is non-zero otherwise, and when no GPU
is found.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
LENGTH, N_PARTITIONS = 29_903, 8
INGEST_GENOMES = 4096
VM_BATCH = 4096
VM_TIMED_BATCHES = 5
TWO_TIER_BUDGET_GB = "4"


def say(*args):
    print(*args, flush=True)


class Failure(Exception):
    pass


def check(condition, what):
    """A comparison the smoke test stands on (kept under python -O)."""
    if not condition:
        raise Failure(f"check failed: {what}")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as ex:
        return f"nvidia-smi unavailable ({ex})"


# ---------------------------------------------------------------------------
# child phases (run with the GPU visible)
# ---------------------------------------------------------------------------


def _child_setup():
    sys.path.insert(0, REPO)
    from lapis_silo_tpu.compile_cache import configure

    return configure()


def child_identity(args) -> dict:
    cache = _child_setup()
    import jax

    devices = jax.devices()
    dev = devices[0]
    say(f"jax {jax.__version__}: {len(devices)} x {dev.platform} "
        f"({dev.device_kind}); compile cache {cache}")
    say(f"nvidia-smi: {nvidia_smi()}")
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform}")
    from lapis_silo_tpu.ops import vm_kernel

    t0 = time.time()
    path = vm_kernel.build()
    say(f"CUDA filter VM built in {time.time() - t0:.1f}s: "
        f"{os.path.relpath(path, REPO)}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def _executable_report(name, jitted, *call_args):
    compiled = jitted.lower(*call_args).compile()
    say(f"  memory_analysis[{name}]: {compiled.memory_analysis()}")


def _trace_summary(label, trace_dir):
    """Per device line of a jax.profiler trace: event count, busy time and
    the most frequent event names."""
    import collections
    import glob

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        say(f"  trace[{label}]: no xplane file under {trace_dir}")
        return
    data = jax_profile_data(paths[-1])
    for plane in data.planes:
        if "GPU" not in plane.name and "gpu" not in plane.name:
            continue
        for line in plane.lines:
            names = collections.Counter()
            busy = 0
            for event in line.events:
                names[event.name[:48]] += 1
                busy += event.duration_ns
            if names:
                say(f"  trace[{label}] {plane.name} / {line.name}: "
                    f"{sum(names.values())} events, {busy / 1e6:.3f} ms "
                    f"busy; top {names.most_common(5)}")


def jax_profile_data(path):
    from jax.profiler import ProfileData

    return ProfileData.from_file(path)


def _median_time(run, inputs):
    """Median seconds of run(x) over distinct inputs, each ended by a
    host pull (one untimed warm call first)."""
    import numpy as np

    np.asarray(run(inputs[0]))
    times = []
    for x in inputs:
        t0 = time.perf_counter()
        np.asarray(run(x))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _distinct_filters(engine, queries):
    """Device-resident filter words of several distinct count queries."""
    from lapis_silo_tpu.query.engine import Query

    out = [engine.evaluate_device(Query(q).filter) for q in queries[1:8]]
    return out[:6]


def _numpy_mutations(db, filter_words):
    """[S, L] Mutations counts of the nucleotide segment on the host."""
    total = None
    for partition, words in zip(db.partitions, filter_words):
        counts = partition.nuc_sequences["main"].mutation_counts(words)
        total = counts if total is None else total + counts
    return total


def _host_words(db, filter_expr):
    from lapis_silo_tpu.query import ast
    from lapis_silo_tpu.query.ir import HostEvaluator

    out = []
    for partition in db.partitions:
        node = filter_expr.compile(db, partition, ast.NONE)
        out.append(HostEvaluator(partition.sequence_count).evaluate(node))
    return out


def child_kernels(args) -> dict:
    _child_setup()
    import jax
    import numpy as np

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.ops import reductions, vm
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.storage.snapshot import save_database
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    t0 = time.time()
    db = synthetic_database(n_rows=args.rows, length=LENGTH,
                            n_partitions=N_PARTITIONS, seed=args.seed)
    say(f"corpus {args.rows} x {LENGTH} x {N_PARTITIONS} built in "
        f"{time.time() - t0:.1f}s")
    saver = threading.Thread(
        target=lambda: save_database(db, os.path.join(args.work, "data")))
    saver.start()

    t0 = time.time()
    dense = de.DeviceEngine(db)
    jax.block_until_ready(dense.bank)
    check(dense.n_sparse == 0, "the real-width corpus must be all-dense")
    say(f"dense engine: bank {dense.bank.nbytes / 1e9:.2f} GB "
        f"({dense.n_rows} rows x {dense.n_flat_words} words) in "
        f"{time.time() - t0:.1f}s; {dense.stats()}")
    t0 = time.time()
    two_tier = de.DeviceEngine(db, sparse_min_words=1)
    jax.block_until_ready(two_tier.sparse_stream[0])
    check(two_tier.n_sparse > 0 and two_tier.pool_slots > 0,
          "two-tier engine without sparse rows or pool")
    say(f"two-tier engine: stream "
        f"{two_tier.sparse_stream[0].nbytes / 1e9:.2f} GB, "
        f"{two_tier.n_sparse} sparse rows, pool {two_tier.pool_slots} slots "
        f"in {time.time() - t0:.1f}s")
    results = {}

    # -- the filter VM: CUDA kernel vs the XLA interpreter -----------------
    batches = []
    t0 = time.time()
    for b in range(VM_TIMED_BATCHES):
        queries = sample_count_queries(db, VM_BATCH, seed=100 + b)
        batches.append([dense.lower(Query(q).filter)[0] for q in queries])
    say(f"lowered {VM_TIMED_BATCHES} x {VM_BATCH} queries in "
        f"{time.time() - t0:.1f}s")
    captured = []
    real_dispatch = dense._dispatch

    def capture(*a, **k):
        captured.append((a, k))
        return real_dispatch(*a, **k)

    dense._dispatch = capture
    top = de._BATCH_LEN_BUCKETS[-1]  # one executable for every batch
    kernel_counts = [dense.count_programs(p, min_bucket=top)
                     for p in batches]
    dense._dispatch = real_dispatch
    check(len(captured) == VM_TIMED_BATCHES,
          f"{len(captured)} dispatches for {VM_TIMED_BATCHES} batches")
    (bucket, n_dyn, _code, dyn_dev, _k, _m, _sp, n_regs, output,
     _n) = captured[0][0]
    zero_rows = dense._zero_sparse_rows()
    blobs = [np.append(a[2].reshape(-1), np.int32(vm._round_instr(a[9])))
             for a, _k in captured]
    n_instr = [int(a[9]) for a, _k in captured]
    run_kernel = vm._interpreter(bucket, dense.n_rows, n_dyn, 0,
                                 dense.n_flat_words, output, n_regs)
    real_path = vm.vm_path
    vm.vm_path = lambda: "xla"
    vm._interpreter.cache_clear()
    try:
        run_xla = vm._interpreter(bucket, dense.n_rows, n_dyn, 0,
                                  dense.n_flat_words, output, n_regs)
    finally:
        vm.vm_path = real_path
        vm._interpreter.cache_clear()
    args0 = (jax.device_put(blobs[0]), dense.bank, dyn_dev, zero_rows,
             dense.full_masks)
    _executable_report("vm_kernel multi_count", run_kernel, *args0)
    _executable_report("vm_xla multi_count", run_xla, *args0)
    timing = {}
    for name, run in (("kernel", run_kernel), ("xla", run_xla)):
        np.asarray(run(*args0))  # warm
        times, outs = [], []
        for blob in blobs:
            blob_dev = jax.device_put(blob)
            jax.block_until_ready(blob_dev)
            t = time.perf_counter()
            out = np.asarray(run(blob_dev, *args0[1:]))
            times.append(time.perf_counter() - t)
            outs.append(out)
        timing[name] = (times, outs)
    for b in range(VM_TIMED_BATCHES):
        k_out, x_out = timing["kernel"][1][b], timing["xla"][1][b]
        np.testing.assert_array_equal(k_out, x_out)
    say(f"VM kernel == XLA VM on {VM_TIMED_BATCHES} batches "
        f"({n_instr} instructions)")
    for name in ("kernel", "xla"):
        times = sorted(timing[name][0])
        med = times[len(times) // 2]
        per = med / (sum(n_instr) / len(n_instr)) * 1e6
        say(f"VM {name}: batch median {med * 1e3:.3f} ms "
            f"(all {[round(t * 1e3, 3) for t in timing[name][0]]} ms), "
            f"{per:.4f} us/instruction")
        results[f"vm_{name}_batch_ms"] = med * 1e3
        results[f"vm_{name}_us_per_instr"] = per
    if args.trace:
        for name, run in (("kernel", run_kernel), ("xla", run_xla)):
            trace_dir = os.path.join(args.trace, f"vm_{name}")
            with jax.profiler.trace(trace_dir):
                np.asarray(run(jax.device_put(blobs[1]), *args0[1:]))
            _trace_summary(f"VM {name}", trace_dir)
    # the served path's counts: kernel counts vs the host oracle (a sample)
    sample = sample_count_queries(db, 64, seed=100)
    want = [int(sum(int(np.bitwise_count(w).sum())
                    for w in _host_words(db, Query(q).filter)))
            for q in sample]
    check(kernel_counts[0][:64] == want, "VM kernel counts != host oracle")

    # -- single-query words (the 'compact' / 'words' executables) ----------
    probe = Query(sample[2]).filter
    for engine_name, engine in (("dense", dense), ("two_tier", two_tier)):
        got = engine.evaluate(probe)
        for g, w in zip(got, _host_words(db, probe)):
            np.testing.assert_array_equal(g, w)
    say("single-query filter words == host evaluator (dense, two-tier)")

    # -- Mutations: dense XLA reduction and sparse segment-sum vs numpy ----
    filt = Query(json.dumps({
        "action": {"type": "Aggregated"},
        "filterExpression": {"type": "Or", "children": [
            {"type": "HasNucleotideMutation", "position": 100},
            {"type": "HasNucleotideMutation", "position": 20000}]}})).filter
    host_filter = _host_words(db, filt)
    want_mut = _numpy_mutations(db, host_filter)
    meta = dense.segment_meta[("nuc", "main")]
    filters = dense._filters_for(host_filter)
    _executable_report("mutations_dense", reductions._mutation_counts_jit,
                       dense.bank, filters, meta["offset"], meta["n_stored"])
    got = dense.mutation_counts("nuc", "main", host_filter)
    np.testing.assert_array_equal(got, want_mut)
    seg_bytes = meta["n_stored"] * dense.n_flat_words * 4
    dt = _median_time(
        lambda f: reductions._mutation_counts_jit(
            dense.bank, f, meta["offset"], meta["n_stored"]),
        _distinct_filters(dense, sample))
    results["mutations_dense_reduction_ms"] = dt * 1e3
    results["mutations_dense_gbps"] = seg_bytes / dt / 1e9
    say(f"dense Mutations == numpy; reduction median {dt * 1e3:.3f} ms over "
        f"{seg_bytes / 1e9:.2f} GB -> {seg_bytes / dt / 1e9:.1f} GB/s")
    stream = two_tier.sparse_stream[0]
    starts, lens = two_tier._sparse_bounds_dev
    tt_filters = two_tier._filters_for(host_filter)
    _executable_report("mutations_sparse",
                       reductions._sparse_mutation_counts_jit, stream,
                       tt_filters, starts, lens, N_PARTITIONS)
    got = two_tier.mutation_counts("nuc", "main", host_filter)
    np.testing.assert_array_equal(got, want_mut)
    dt = _median_time(
        lambda f: reductions._sparse_mutation_counts_jit(
            stream, f, starts, lens, N_PARTITIONS),
        _distinct_filters(dense, sample))
    results["mutations_sparse_ms"] = dt * 1e3
    say(f"sparse Mutations == numpy; segment-sum median {dt * 1e3:.3f} ms "
        f"over {stream.nbytes / 1e9:.2f} GB of stream")

    # -- densify: sparse leaves scattered on device vs dense bank rows -----
    tmeta = two_tier.segment_meta[("nuc", "main")]
    k = 64
    leaf_ids = list(range(0, two_tier.n_sparse, two_tier.n_sparse // k))[:k]
    k_b, e_b, (st, ln, _ids) = two_tier._assemble_sparse(leaf_ids)
    densify = vm._densify_jit(k_b, e_b, two_tier.n_flat_words, N_PARTITIONS)
    _executable_report("densify", densify, stream, jax.device_put(st),
                       jax.device_put(ln))
    rows = np.asarray(densify(stream, jax.device_put(st), jax.device_put(ln)))
    bank_rows = [int(meta["row_map"][tmeta["sparse_sym_ids"][i],
                                     tmeta["sparse_pos_ids"][i]])
                 for i in leaf_ids]
    want_rows = np.asarray(dense.bank[np.asarray(bank_rows)])
    np.testing.assert_array_equal(rows[:k], want_rows)
    bounds = []
    for shift in range(5):
        ids = [(i + shift) % two_tier.n_sparse for i in leaf_ids]
        _kb, _eb, (st_s, ln_s, _i) = two_tier._assemble_sparse(ids)
        bounds.append((jax.device_put(st_s), jax.device_put(ln_s)))
    results["densify_64_leaves_ms"] = _median_time(
        lambda b: densify(stream, *b), bounds) * 1e3
    say(f"densify of {k} leaves == dense bank rows "
        f"({results['densify_64_leaves_ms']:.3f} ms, E budget {e_b})")

    # -- the pooled VM: a batch through the two-tier engine ---------------
    pool_progs = [two_tier.lower(Query(q).filter)[0] for q in sample]
    pool_counts = two_tier.count_programs(pool_progs)
    check(pool_counts == want, "two-tier (pooled) counts != host oracle")
    check(two_tier.count_programs(pool_progs) == want,
          "repeated pooled counts != host oracle")
    check(two_tier.pool_hits > 0, "no pool hits on the repeat")
    say(f"pooled two-tier counts == host oracle; {two_tier.stats()}")
    if two_tier._pool_e_budgets:
        kb = min(two_tier._pool_e_budgets)
        run = vm._pool_update_jit(kb, N_PARTITIONS, two_tier.n_flat_words,
                                  None, two_tier._pool_e_budget(kb))
        _executable_report(
            "pool_update", run, two_tier.leaf_pool, stream,
            two_tier._ensure_bounds_dev(),
            jax.device_put(np.zeros(2 * kb, np.int32)))

    # -- group-by vs numpy --------------------------------------------------
    words = dense.evaluate_device(filt)
    codes, n_groups, decode = dense.group_codes_for(["country"])
    _executable_report("group_counts", reductions._group_counts_jit, words,
                       codes, 64 + 1)
    got_groups = dict(dense.group_counts(filt, ["country"]))
    want_groups = {}
    from lapis_silo_tpu.ops import bitset

    for partition, fw in zip(db.partitions, host_filter):
        ids = partition.columns["country"].ids
        bits = bitset.unpack_words(fw, partition.sequence_count)
        for vid, c in zip(*np.unique(ids[bits], return_counts=True)):
            key = decode(int(vid))
            want_groups[key] = want_groups.get(key, 0) + int(c)
    check(got_groups == want_groups, f"group-by {got_groups} != {want_groups}")
    say(f"group-by country == numpy ({len(got_groups)} groups)")

    stats = jax.devices()[0].memory_stats() or {}
    say(f"device peak_bytes_in_use {stats.get('peak_bytes_in_use')} of "
        f"bytes_limit {stats.get('bytes_limit')}")
    t0 = time.time()
    saver.join()
    say(f"snapshot saved (waited {time.time() - t0:.1f}s)")
    return results


def child_mesh(args) -> dict:
    """--chips 4: a mesh DeviceEngine vs a one-card engine and the host."""
    _child_setup()
    import jax
    import numpy as np

    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.query.engine import Query
    from lapis_silo_tpu.storage.snapshot import save_database
    from lapis_silo_tpu.testing import sample_count_queries, synthetic_database

    devices = jax.devices()
    check(len(devices) == 4, f"four devices expected: {devices}")
    t0 = time.time()
    db = synthetic_database(n_rows=args.rows, length=LENGTH,
                            n_partitions=N_PARTITIONS, seed=args.seed)
    saver = threading.Thread(
        target=lambda: save_database(db, os.path.join(args.work, "data")))
    saver.start()
    mesh = de.DeviceEngine(db)
    mesh_tt = de.DeviceEngine(db, sparse_min_words=1)
    one = de.DeviceEngine(db, devices=devices[:1])
    check(mesh.mesh is not None and mesh_tt.mesh is not None,
          "engines not sharded over the mesh")
    check(mesh_tt.pool_slots > 0, "mesh pool inactive")
    say(f"engines up in {time.time() - t0:.1f}s: mesh {mesh.stats()}, "
        f"one-card {one.stats()}, mesh two-tier {mesh_tt.stats()}")
    queries = sample_count_queries(db, VM_BATCH, seed=7)
    filters = [Query(q).filter for q in queries]
    want_one = one.count_batch(filters)
    check(mesh.count_batch(filters) == want_one,
          "mesh counts != one-card counts")
    check(mesh_tt.count_batch(filters) == want_one,
          "mesh two-tier counts != one-card counts")
    # a working set that fits the pool: the repeat must hit, not densify
    hot = filters[:256]
    check(mesh_tt.count_batch(hot) == want_one[:256],
          "mesh pooled counts != one-card counts")
    misses = mesh_tt.pool_misses
    check(mesh_tt.count_batch(hot) == want_one[:256],
          "repeated mesh pooled counts != one-card counts")
    check(mesh_tt.pool_hits > 0 and mesh_tt.pool_misses == misses,
          "the repeated working set missed the mesh pool")
    sample = want_one[:64]
    host = [int(sum(int(np.bitwise_count(w).sum())
                    for w in _host_words(db, f))) for f in filters[:64]]
    check(sample == host, "mesh counts != host oracle")
    say(f"mesh counts == one-card == host ({len(filters)} queries); "
        f"mesh pool {mesh_tt.stats()}")
    filt = Query(json.dumps({
        "action": {"type": "Aggregated"},
        "filterExpression": {"type": "HasNucleotideMutation",
                             "position": 100}})).filter
    host_filter = _host_words(db, filt)
    want_mut = _numpy_mutations(db, host_filter)
    for engine in (mesh, mesh_tt, one):
        np.testing.assert_array_equal(
            engine.mutation_counts("nuc", "main", host_filter), want_mut)
    check((mesh.group_counts(filt, ["country"])
            == one.group_counts(filt, ["country"])
            == mesh_tt.group_counts(filt, ["country"])),
          "mesh group-by != one-card group-by")
    say("mesh Mutations (dense, sparse) == numpy; group-by == one-card")
    saver.join()
    return {"devices": len(devices)}


CHILDREN = {"identity": child_identity, "kernels": child_kernels,
            "mesh": child_mesh}


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------




def run_child(phase, args, env, timeout):
    result_path = os.path.join(args.work, f"{phase}.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", phase,
           "--work", args.work, "--seed", str(args.seed),
           "--rows", str(args.rows)]
    if args.trace:
        cmd += ["--trace", os.path.abspath(args.trace)]
    say(f"== phase {phase}")
    t0 = time.time()
    proc = subprocess.Popen(cmd, env=env, start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise Failure(f"phase {phase} timed out after {timeout}s")
    if rc != 0:
        raise Failure(f"phase {phase} failed (exit {rc})")
    with open(result_path) as f:
        result = json.load(f)
    say(f"== phase {phase} ok in {time.time() - t0:.1f}s")
    return result


def write_ingest_corpus(directory, seed):
    """A seeded FASTA + TSV corpus in the reference's input layout."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reference = alphabet[rng.integers(0, 4, LENGTH)]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "reference_genomes.json"), "w") as f:
        json.dump({"nucleotideSequences": [
            {"name": "main", "sequence": reference.tobytes().decode()}],
            "genes": []}, f)
    countries = ["Switzerland", "Germany", "France", "Italy"]
    with open(os.path.join(directory, "metadata.tsv"), "w") as meta, \
            open(os.path.join(directory, "nuc_main.fasta"), "wb") as fasta:
        meta.write("key\tdate\tcountry\n")
        for i in range(INGEST_GENOMES):
            genome = reference.copy()
            pos = rng.integers(0, LENGTH, 30)
            genome[pos] = alphabet[rng.integers(0, 4, 30)]
            meta.write(f"SEQ_{i}\t2021-03-{1 + i % 28:02d}\t"
                       f"{countries[i % 4]}\n")
            fasta.write(b">SEQ_%d\n" % i + genome.tobytes() + b"\n")
    with open(os.path.join(directory, "database_config.yaml"), "w") as f:
        f.write("schema:\n"
                "  instanceName: chip_smoke\n"
                "  metadata:\n"
                "    - name: key\n      type: string\n"
                "    - name: date\n      type: date\n"
                "    - name: country\n      type: string\n"
                "      generateIndex: true\n"
                "  primaryKey: key\n"
                "  dateToSortBy: date\n")


def phase_ingest(args, env):
    sys.path.insert(0, REPO)
    from lapis_silo_tpu.config.yaml_subset import dump_mapping

    say("== phase ingest")
    t0 = time.time()
    inp = os.path.join(args.work, "ingest_input")
    out = os.path.join(args.work, "ingest_output")
    write_ingest_corpus(inp, args.seed)
    cfg = os.path.join(args.work, "preprocessing_config.yaml")
    with open(cfg, "w") as f:
        f.write(dump_mapping({
            "inputDirectory": inp, "outputDirectory": out,
            "intermediateResultsDirectory": os.path.join(args.work, "tmp"),
            "metadataFilename": "metadata.tsv",
            "referenceGenomeFilename": "reference_genomes.json"}))
    say(f"  corpus of {INGEST_GENOMES} genomes x {LENGTH} written in "
        f"{time.time() - t0:.1f}s")
    proc = subprocess.run(
        [sys.executable, "-m", "lapis_silo_tpu.cli", "--preprocessing",
         "--preprocessingConfig", cfg, "--databaseConfig",
         os.path.join(inp, "database_config.yaml")],
        cwd=args.work, env=env, timeout=600)
    if proc.returncode != 0:
        raise Failure(f"ingest failed (exit {proc.returncode})")
    from lapis_silo_tpu.query.engine import QueryEngine
    from lapis_silo_tpu.storage.snapshot import (find_newest_snapshot,
                                                 load_database)

    db = load_database(find_newest_snapshot(out))
    got = QueryEngine(db, use_device=False).execute(json.dumps({
        "action": {"type": "Aggregated"},
        "filterExpression": {"type": "True"}}))
    count = got["queryResult"][0]["count"]
    if count != INGEST_GENOMES:
        raise Failure(f"ingested snapshot holds {count} genomes")
    say(f"== phase ingest ok in {time.time() - t0:.1f}s "
        f"({count} genomes in the snapshot)")


def served_queries():
    pos = [101, 2001, 15001, 29001, 7777, 123]
    leaf = [{"type": "HasNucleotideMutation", "position": p} for p in pos]
    counts = [
        {"type": "True"},
        {"type": "And", "children": leaf[:2]},
        {"type": "Or", "children": [leaf[2], {"type": "Not",
                                              "child": leaf[3]}]},
        {"type": "And", "children": [
            leaf[4], {"type": "StringEquals", "column": "country",
                      "value": "Germany"}]},
    ]
    n_of = {"type": "N-Of", "numberOfMatchers": 2, "matchExactly": False,
            "children": leaf[:4]}
    out = [{"action": {"type": "Aggregated"}, "filterExpression": f}
           for f in counts + [n_of]]
    out += [
        {"action": {"type": "Aggregated", "groupByFields": ["country"]},
         "filterExpression": {"type": "Or", "children": leaf[:3]}},
        {"action": {"type": "Aggregated", "groupByFields": ["date"]},
         "filterExpression": n_of},
        {"action": {"type": "Mutations", "minProportion": 0.05},
         "filterExpression": {"type": "Or", "children": leaf[:2]}},
        {"action": {"type": "Details", "fields": ["key", "date", "country"],
                    "orderByFields": ["date", "key"], "limit": 10},
         "filterExpression": {"type": "And", "children": leaf[1:3]}},
    ]
    return [json.dumps(q) for q in out]


def _http(url, body=None, timeout=600):
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve(args, env, name, host_answers, extra_env=None,
                two_tier=False, devices=1):
    say(f"== phase {name}")
    t0 = time.time()
    port = free_port()
    log_path = os.path.join(args.work, f"{name}_server.log")
    server_env = dict(env, **(extra_env or {}))
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lapis_silo_tpu.cli", "--api",
             "--dataDirectory", os.path.join(args.work, "data"),
             "--port", str(port)],
            cwd=args.work, env=server_env, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + args.serve_timeout
        while True:
            if proc.poll() is not None:
                raise Failure(f"{name}: server exited ({proc.returncode})")
            try:
                info = _http(base + "/info", timeout=10)
                if info.get("sequenceCount"):
                    break
            except OSError:
                pass
            if time.time() > deadline:
                raise Failure(f"{name}: server not serving after "
                              f"{args.serve_timeout}s")
            time.sleep(2)
        say(f"  serving after {time.time() - t0:.1f}s: /info {info}")
        if info["sequenceCount"] != args.rows:
            raise Failure(f"{name}: /info sequenceCount "
                          f"{info['sequenceCount']}")
        queries = served_queries()
        rounds = 2 if two_tier else 1
        for r in range(rounds):
            t1 = time.time()
            for q, want in zip(queries, host_answers):
                got = _http(base + "/query", q.encode())
                if got != want:
                    raise Failure(f"{name}: {q} answered {str(got)[:400]}, "
                                  f"host says {str(want)[:400]}")
            say(f"  round {r + 1}: {len(queries)} answers == host engine "
                f"({time.time() - t1:.1f}s)")
        dev = _http(base + "/info?tpu=true")
        engine = dev.get("deviceEngine", {})
        say(f"  /info?tpu=true: {engine}, hostFallbacks "
            f"{dev.get('hostFallbacks')}")
        if (engine.get("platform") != "gpu" or engine.get("vmPath") != "kernel"
                or engine.get("devices") != devices):
            raise Failure(f"{name}: device engine not on the GPU kernel "
                          f"path over {devices} card(s)")
        if dev.get("hostFallbacks", 0) != 0:
            raise Failure(f"{name}: {dev['hostFallbacks']} queries fell back "
                          "to the host")
        if two_tier and not (engine.get("sparseRows", 0) > 0
                             and engine.get("poolSlots", 0) > 0
                             and engine.get("poolHits", 0) > 0):
            raise Failure(f"{name}: sparse tier / pool inactive: {engine}")
        with open(log_path) as f:
            front = [line.strip() for line in f if "HTTP front-end" in line]
        say(f"  {front[-1] if front else 'HTTP front-end not logged'}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    say(f"== phase {name} ok in {time.time() - t0:.1f}s")


def host_oracle(args, box):
    """The host-only engine's answers to the served queries (numpy only)."""
    from lapis_silo_tpu.query.engine import QueryEngine
    from lapis_silo_tpu.testing import synthetic_database

    t0 = time.time()
    db = synthetic_database(n_rows=args.rows, length=LENGTH,
                            n_partitions=N_PARTITIONS, seed=args.seed)
    engine = QueryEngine(db, use_device=False)
    box["answers"] = [engine.execute(q) for q in served_queries()]
    box["seconds"] = time.time() - t0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=1_048_576,
                        help="genomes in the phase 3-5 corpus (the default "
                             "is the real size)")
    parser.add_argument("--serve-timeout", type=int, default=420)
    parser.add_argument("--trace", default=None,
                        help="directory for jax.profiler traces of one VM "
                             "batch on each path (kernels phase)")
    parser.add_argument("--child", choices=sorted(CHILDREN))
    parser.add_argument("--work")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child:
        result = CHILDREN[args.child](args)
        with open(os.path.join(args.work, f"{args.child}.json"), "w") as f:
            json.dump(result, f)
        return 0
    if not os.path.isdir(os.path.join(REPO, "lapis_silo_tpu")):
        print("chip_smoke.py: the lapis_silo_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    t_start = time.time()
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = REPO + os.pathsep + child_env.get(
        "PYTHONPATH", "")
    # this process stays on the host: its numpy oracle never needs a device
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)
    args.work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # native code is built here from the committed sources, never
        # taken as found: the host kernels and the HTTP front-end are
        # rebuilt; the NDJSON scanner (off this path; it needs zstd's
        # headers) is removed so its Python reader serves; the CUDA VM
        # is rebuilt by the identity phase
        native = os.path.join(REPO, "native")
        say("== rebuilding native libraries (make -B -C native)")
        make = subprocess.run(["make", "-B", "-C", native,
                               "libsilo_native.so", "libsilo_http.so"],
                              capture_output=True, text=True, timeout=600)
        if make.returncode != 0:
            raise Failure(f"native build failed:\n{make.stderr[-2000:]}")
        for stale in ("libsilo_ndjson.so", "build"):
            path = os.path.join(native, stale)
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.exists(path):
                os.remove(path)
        device = run_child("identity", args, child_env, 600)
        if args.chips == 4:
            if device["count"] != 4:
                raise Failure(f"--chips 4 needs four GPUs, found "
                              f"{device['count']}")
            box = {}
            oracle = threading.Thread(target=host_oracle, args=(args, box))
            oracle.start()
            run_child("mesh", args, child_env, 1500)
            oracle.join()
            phase_serve(args, child_env, "serve_mesh", box["answers"],
                        devices=4)
        else:
            box = {}
            oracle = threading.Thread(target=host_oracle, args=(args, box))
            oracle.start()
            phase_ingest(args, child_env)
            results = run_child("kernels", args, child_env, 900)
            say(f"kernel results: {json.dumps(results)}")
            oracle.join()
            say(f"host oracle answers ready ({box['seconds']:.1f}s)")
            phase_serve(args, child_env, "serve", box["answers"])
            phase_serve(args, child_env, "serve_two_tier", box["answers"],
                        {"SILO_DENSE_BANK_BUDGET_GB": TWO_TIER_BUDGET_GB},
                        two_tier=True)
    except Failure as ex:
        print(f"chip_smoke FAILED: {ex}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    say(f"all phases passed in {time.time() - t_start:.1f}s")
    say(f"nvidia-smi: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
