"""Device kernels and the plain XLA forms they are checked against (CPU).

The VM kernel itself is CUDA (native/silo_vm.cu) and runs only on the
card (`gpu` marker); here its wrapper runs with the kernel's jnp
reference (vm_kernel.reference_call) in place of the FFI call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def _random_program(rng, n_rows, n_dyn, n_k, n_regs, n_alu, emit_p):
    from lapis_silo_tpu.ops import device_engine as de

    ops, opers, specs = [], [], []

    def emit(op, operand, dst, ra=0, rb=0, mode=0, bsrc=de.B_REG):
        ops.append(op)
        opers.append(operand)
        specs.append(dst | (ra << 8) | (rb << 16) | (mode << 24)
                     | (bsrc << 28))

    qi = 0
    for _ in range(n_alu):
        bsrc = int(rng.integers(0, 6))
        hi = {de.B_BANK: n_rows, de.B_DYN: n_dyn, de.B_SPARSE: n_k}.get(bsrc, 1)
        emit(de.ALU, int(rng.integers(0, hi)), int(rng.integers(0, n_regs)),
             int(rng.integers(0, n_regs)), int(rng.integers(0, n_regs)),
             int(rng.integers(0, 5)), bsrc)
        if rng.random() < emit_p:
            emit(de.EMIT_COUNT, qi, de.NO_DST)
            qi += 1
    return ops, opers, specs, qi


def _vm_inputs(seed, pw, n_rows=24, n_dyn=3, n_k=5):
    rng = np.random.default_rng(seed)
    bank = rng.integers(0, 1 << 32, size=(n_rows, pw), dtype=np.uint32)
    dyn = rng.integers(0, 1 << 32, size=(n_dyn, pw), dtype=np.uint32)
    sparse = rng.integers(0, 1 << 32, size=(n_k, pw), dtype=np.uint32)
    full = np.full(pw, 0xFFFFFFFF, dtype=np.uint32)
    full[-40:] = 0x7  # ragged tail like a real partition mask
    return rng, bank, dyn, sparse, full


@pytest.mark.parametrize("pw,split", [(2048, False), (2048, True),
                                      (2052, True), (516, True)])
def test_vm_kernel_matches_xla_interpreter(vm_kernel_reference, pw, split):
    """The VM kernel's wrapper (query-boundary chunks, word tiles that do
    not divide the axis) vs the XLA while_loop interpreter. Unsplit runs
    take a random program exercising every b-source, ALU mode, EMIT_COUNT
    and the padded NOP tail. Split runs take programs built like lowered
    queries (each writes a register before reading it), the condition
    under which chunks may start from zeroed registers."""
    from lapis_silo_tpu.ops import device_engine as de

    rng, bank, dyn, sparse, full = _vm_inputs(5, pw)
    n_rows, n_dyn, n_k, n_regs = bank.shape[0], dyn.shape[0], 5, 8
    bucket = 64
    if split:
        # every query: r0 = source; r0 = r0 op source; emit
        ops, opers, specs, qi = [], [], [], 0
        for q in range(9):
            for step in range(1 + q % 3):
                bsrc = int(rng.integers(1, 6))
                hi = {de.B_BANK: n_rows, de.B_DYN: n_dyn,
                      de.B_SPARSE: n_k}.get(bsrc, 1)
                mode = de.M_MOVB if step == 0 else int(rng.integers(1, 5))
                ops.append(de.ALU)
                opers.append(int(rng.integers(0, hi)))
                specs.append((mode << 24) | (bsrc << 28))
            ops.append(de.EMIT_COUNT)
            opers.append(q)
            specs.append(de.NO_DST)
            qi += 1
    else:
        ops, opers, specs, qi = _random_program(rng, n_rows, n_dyn, n_k,
                                                n_regs, 12, 0.4)
    code = de.pack_code_array(bucket, ops, opers, specs)
    blob = np.append(code.reshape(-1), np.int32(de._round_instr(len(ops))))
    args = (jnp.asarray(blob), jnp.asarray(bank), jnp.asarray(dyn),
            jnp.asarray(sparse), jnp.asarray(full))

    ref = vm_kernel_reference
    n_instr = jnp.int32(de._round_instr(len(ops)))
    got_words, got_counts = ref.vm_run(
        jnp.asarray(code), n_instr, *args[1:], n_regs=n_regs, split=split)
    if split:
        assert ref.n_chunks_for(pw) > 1
    # the XLA interpreter (vm_path() is patched to the kernel route, so
    # build the plain body directly)
    run = de.build_run_one_with_emit(bucket, n_rows, n_dyn, pw,
                                     n_sparse_k=n_k, n_regs=n_regs)
    want_words, want_counts = jax.jit(run)(jnp.asarray(code), *args[1:],
                                           n_instr)
    np.testing.assert_array_equal(np.asarray(got_words),
                                  np.asarray(want_words))
    np.testing.assert_array_equal(np.asarray(got_counts)[:qi],
                                  np.asarray(want_counts)[:qi])


@pytest.mark.parametrize("n_chunks", [1, 3, 7, 64])
def test_chunk_bounds_on_query_boundaries(n_chunks):
    """Every bound is a query start (0 or just after an EMIT_COUNT) or the
    end; bounds never decrease; the last chunk holds the last query."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.ops import vm_kernel

    rng = np.random.default_rng(n_chunks)
    ops, opers, specs = [], [], []
    for q in range(20):
        for _ in range(int(rng.integers(1, 5))):
            ops.append(de.ALU)
            opers.append(0)
            specs.append(de.M_MOVB << 24 | de.B_FULL << 28)
        ops.append(de.EMIT_COUNT)
        opers.append(q)
        specs.append(de.NO_DST)
    n = de._round_instr(len(ops))
    code = de.pack_code_array(256, ops, opers, specs)
    bounds = np.asarray(vm_kernel.chunk_bounds(jnp.asarray(code[1]),
                                               jnp.int32(n), n_chunks))
    starts = {0} | {i + 1 for i, op in enumerate(ops)
                    if op == de.EMIT_COUNT}
    assert bounds.shape == (n_chunks + 1,)
    assert bounds[0] == 0 and bounds[-1] == n
    assert (np.diff(bounds) >= 0).all()
    assert all(int(b) in starts or b == n for b in bounds)
    assert bounds[-2] < n  # the last chunk is never empty


def test_vm_wrapper_rejects_unaligned_words(vm_kernel_reference):
    from lapis_silo_tpu.ops import device_engine as de

    pw = 2050
    code = jnp.asarray(de.pack_code_array(16, [], [], []))
    zeros = jnp.zeros((1, pw), jnp.uint32)
    with pytest.raises(ValueError, match="multiple of 4"):
        vm_kernel_reference.vm_run(code, jnp.int32(0), zeros, zeros, zeros,
                                   zeros[0], n_regs=4, split=False)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_engine_pads_words_to_kernel_quantum(n_dev):
    """Each device's share of the flat word axis is a whole number of the
    kernel's 4-word vectors."""
    from lapis_silo_tpu.ops import vm_kernel
    from lapis_silo_tpu.ops.device_engine import DeviceEngine
    from lapis_silo_tpu.testing import synthetic_database

    if len(jax.devices()) < n_dev:
        pytest.skip("needs the virtual multi-device mesh")
    db = synthetic_database(n_rows=97, length=64, n_partitions=3)
    engine = DeviceEngine(db, devices=jax.devices()[:n_dev])
    assert engine.n_words % (vm_kernel.WORD_QUANTUM * n_dev) == 0
    assert (engine.n_flat_words // n_dev) % vm_kernel.WORD_QUANTUM == 0


@pytest.mark.parametrize("platform,want", [("gpu", "kernel"), ("cpu", "xla"),
                                           ("rocm", None)])
def test_vm_path_platform_choice(monkeypatch, platform, want):
    from lapis_silo_tpu.ops import vm

    class FakeDevice:
        pass

    dev = FakeDevice()
    dev.platform = platform
    monkeypatch.setattr(vm.jax, "devices", lambda: [dev])
    if want is None:
        with pytest.raises(RuntimeError, match="no device path"):
            vm.vm_path()
    else:
        assert vm.vm_path() == want


def test_vm_run_sharded_matches_single_device(vm_kernel_reference):
    """The kernel wrapper under shard_map over the 8-device CPU mesh:
    word-sharded bank/dyn/sparse/full, psum-merged EMIT counts — must be
    bit-identical to the single-device wrapper and the XLA interpreter."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device mesh")
    mesh = make_mesh()
    n_dev = mesh.devices.size
    pw = n_dev * 2 * 128
    rng, bank, dyn, sparse, full = _vm_inputs(11, pw, n_rows=12, n_dyn=2,
                                              n_k=3)
    n_regs = 8
    ops, opers, specs, qi = _random_program(rng, 12, 2, 3, n_regs, 10, 0.5)
    code = jnp.asarray(de.pack_code_array(64, ops, opers, specs))
    ni = jnp.int32(de._round_instr(len(ops)))
    args = (jnp.asarray(bank), jnp.asarray(dyn), jnp.asarray(sparse),
            jnp.asarray(full))
    want_words, want_counts = vm_kernel_reference.vm_run(
        code, ni, *args, n_regs=n_regs, split=False)
    got_words, got_counts = vm_kernel_reference.vm_run_sharded(
        mesh, code, ni, *args, n_regs=n_regs, split=False)
    np.testing.assert_array_equal(np.asarray(got_words),
                                  np.asarray(want_words))
    np.testing.assert_array_equal(np.asarray(got_counts)[:qi],
                                  np.asarray(want_counts)[:qi])
    run = de.build_run_one_with_emit(64, 12, 2, pw, n_sparse_k=3,
                                     n_regs=n_regs)
    xla_words, xla_counts = jax.jit(run)(code, *args, ni)
    np.testing.assert_array_equal(np.asarray(got_words),
                                  np.asarray(xla_words))
    np.testing.assert_array_equal(np.asarray(got_counts)[:qi],
                                  np.asarray(xla_counts)[:qi])


@pytest.mark.gpu
def test_cuda_vm_kernel_matches_xla(gpu_device):
    """The compiled CUDA kernel vs the XLA interpreter, split and unsplit,
    on a word axis that does not fill the last tile."""
    from lapis_silo_tpu.ops import device_engine as de
    from lapis_silo_tpu.ops import vm_kernel

    vm_kernel.ensure_registered()
    pw = 4 * 1000
    rng, bank, dyn, sparse, full = _vm_inputs(17, pw)
    ops, opers, specs, qi = _random_program(rng, 24, 3, 5, 8, 40, 0.3)
    code = jnp.asarray(de.pack_code_array(256, ops, opers, specs))
    ni = jnp.int32(de._round_instr(len(ops)))
    args = tuple(jnp.asarray(a) for a in (bank, dyn, sparse, full))
    got_words, got_counts = jax.jit(
        lambda c, n, *a: vm_kernel.vm_run(c, n, *a, n_regs=8, split=False)
    )(code, ni, *args)
    run = de.build_run_one_with_emit(256, 24, 3, pw, n_sparse_k=5, n_regs=8)
    want_words, want_counts = jax.jit(run)(code, *args, ni)
    np.testing.assert_array_equal(np.asarray(got_words),
                                  np.asarray(want_words))
    np.testing.assert_array_equal(np.asarray(got_counts)[:qi],
                                  np.asarray(want_counts)[:qi])


# -- sparse densify (vm._densify_one) and the pool update -----------------


def _stream(segments, rng):
    """Combined stream + (starts, lens) for a list of per-segment sorted
    word-index arrays."""
    from lapis_silo_tpu.ops import sparse_stream as ss

    lens = np.array([len(s) for s in segments], dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    idx = (np.concatenate(segments).astype(np.int32) if len(segments)
           else np.zeros(0, np.int32))
    words = rng.integers(1, 1 << 32, size=idx.shape[0], dtype=np.uint32)
    n_pad = -(-max(len(idx), 1) // ss.COMBINE_BLOCK) * ss.COMBINE_BLOCK
    idx_p = np.zeros(n_pad, np.int32)
    wrd_p = np.zeros(n_pad, np.uint32)
    idx_p[: len(idx)] = idx
    wrd_p[: len(words)] = words
    return ss.combine_stream(idx_p, wrd_p), starts, lens, idx, words


def _segments(kind, rng, n_seg, n_per_leaf, n_words):
    wp = n_words // n_per_leaf
    out = []
    for g in range(n_seg):
        pi = g % n_per_leaf
        if kind == "ragged":
            n = int(rng.integers(0, min(2500, wp)))
        elif kind == "multi_block":
            n = min(1400, wp) if g % 2 else 0
        elif kind == "clustered":
            n = min(180, wp // 4)
        else:  # "sparse_wide"
            n = 2
        if kind == "clustered":
            width = wp // 2
            base = int(rng.integers(0, wp - width))
            w = np.sort(rng.choice(width, size=n, replace=False)) + base
        else:
            w = np.sort(rng.choice(wp, size=n, replace=False))
        out.append((w + pi * wp).astype(np.int32))
    return out


@pytest.mark.parametrize("kind", ["ragged", "multi_block", "clustered",
                                  "sparse_wide"])
def test_densify_rows_matches_xla(kind):
    """vm._densify_one vs a numpy scatter oracle: ragged partition-major
    segments, empty segments, segments longer than a stream block,
    clustered and widely spread word indices."""
    from lapis_silo_tpu.ops import vm

    rng = np.random.default_rng(7)
    k, p = 5, 3
    n_words = 12 * 128
    segments = _segments(kind, rng, k * p, p, n_words)
    comb, starts, lens, idx, words = _stream(segments, rng)
    want = np.zeros((k, n_words), dtype=np.uint32)
    for g, s in enumerate(segments):
        want[g // p, s] = words[starts[g] : starts[g] + lens[g]]
    e_bucket = 1 << int(max(lens.sum(), 1) - 1).bit_length()
    got = np.asarray(jax.jit(lambda *a: vm._densify_one(
        k, e_bucket, n_words, p, *a))(jnp.asarray(comb),
                                      jnp.asarray(starts),
                                      jnp.asarray(lens)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_densify_window_local_matches_global(n_dev):
    """The mesh form (w_off, local_words) writes exactly each device's
    slice of the global rows."""
    from lapis_silo_tpu.ops import vm

    rng = np.random.default_rng(n_dev)
    k, p, n_words = 4, 2, 8 * 128
    segments = _segments("ragged", rng, k * p, p, n_words)
    comb, starts, lens, _idx, _words = _stream(segments, rng)
    e_bucket = 1 << 13
    args = (jnp.asarray(comb), jnp.asarray(starts), jnp.asarray(lens))
    full_rows = np.asarray(vm._densify_one(k, e_bucket, n_words, p, *args))
    local = n_words // n_dev
    for d in range(n_dev):
        part = np.asarray(vm._densify_one(k, e_bucket, n_words, p, *args,
                                          w_off=d * local,
                                          local_words=local))
        np.testing.assert_array_equal(part,
                                      full_rows[:, d * local:(d + 1) * local])


@pytest.mark.parametrize("n_dev", [1, 8])
def test_pool_update_writes_slots(n_dev):
    """_pool_update_jit densifies the listed leaves into their pool slots
    with .at[slots].set — other slots keep their contents, padded ids land
    in the scratch row — single device and word-sharded mesh."""
    from lapis_silo_tpu.ops import vm

    if len(jax.devices()) < n_dev:
        pytest.skip("needs the virtual multi-device mesh")
    rng = np.random.default_rng(3)
    n_leaves, p, n_words = 6, 2, 8 * 128
    segments = _segments("ragged", rng, n_leaves * p, p, n_words)
    comb, starts, lens, _idx, _words = _stream(segments, rng)
    bounds = np.zeros((n_leaves + 1, 2, p), np.int32)
    bounds[:n_leaves, 0] = starts.reshape(n_leaves, p)
    bounds[:n_leaves, 1] = lens.reshape(n_leaves, p)
    leaves = np.asarray(vm._densify_one(n_leaves, 1 << 14, n_words, p,
                                        jnp.asarray(comb),
                                        jnp.asarray(starts),
                                        jnp.asarray(lens)))
    n_slots = 8
    pool0 = rng.integers(0, 1 << 32, size=(n_slots + 1, n_words),
                         dtype=np.uint32)
    k_bucket = 4
    ids, slots = [4, 1, 5], [6, 0, 3]
    blob = np.full(2 * k_bucket, n_leaves, np.int32)
    blob[: len(ids)] = ids
    blob[k_bucket:] = n_slots
    blob[k_bucket : k_bucket + len(slots)] = slots
    mesh = None
    pool = jnp.asarray(pool0)
    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec
        from lapis_silo_tpu.parallel.mesh import make_mesh

        mesh = make_mesh()
        pool = jax.device_put(pool0, NamedSharding(
            mesh, PartitionSpec(None, "seq")))
    run = vm._pool_update_jit(k_bucket, p, n_words, mesh, 1 << 14)
    got = np.asarray(run(pool, jnp.asarray(comb), jnp.asarray(bounds),
                         jnp.asarray(blob)))
    want = pool0.copy()
    for leaf, slot in zip(ids, slots):
        want[slot] = leaves[leaf]
    want[n_slots] = 0  # the padded id's empty leaf lands in scratch
    np.testing.assert_array_equal(got, want)


def test_combine_stream_numpy_jnp_parity():
    """combine_stream's numpy (engine init) and jnp (in-jit) branches
    must produce identical block-interleaved bytes, and the documented
    entry->row mapping must hold."""
    from lapis_silo_tpu.ops import sparse_stream as ss

    rng = np.random.default_rng(3)
    e = 2 * ss.COMBINE_BLOCK
    idx = rng.integers(0, 1 << 20, size=e).astype(np.int32)
    words = rng.integers(0, 1 << 32, size=e, dtype=np.uint32)
    a = ss.combine_stream(idx, words)
    b = np.asarray(ss.combine_stream(jnp.asarray(idx), jnp.asarray(words)))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (e // 64, 128)
    for pos in [0, 1, 127, 128, 1023, 1024, 1025, e - 1]:
        row = ss.comb_idx_row(pos)
        assert a[row, pos & 127] == np.uint32(idx[pos])
        assert a[row + ss.COMBINE_WORD_ROW_OFF, pos & 127] == words[pos]
    got_idx, got_words = ss.split_stream(a)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_words, words)


# -- Mutations reductions -------------------------------------------------


@pytest.mark.parametrize("start,n_seg", [(0, 32), (5, 7), (17, 1), (3, 29)])
def test_mutation_counts_jit_at_offsets(start, n_seg):
    """_mutation_counts_jit: popcount(bank[start:start+n] & filter) per row
    at any row offset and segment length."""
    from lapis_silo_tpu.ops.reductions import _mutation_counts_jit

    rng = np.random.default_rng(start * 31 + n_seg)
    bank = rng.integers(0, 2**32, size=(32, 3 * 1024 + 4), dtype=np.uint32)
    filters = rng.integers(0, 2**32, size=bank.shape[1], dtype=np.uint32)
    got = np.asarray(_mutation_counts_jit(jnp.asarray(bank),
                                          jnp.asarray(filters), start, n_seg))
    want = (np.bitwise_count(bank[start:start + n_seg] & filters[None, :])
            .sum(axis=1).astype(np.int32))
    np.testing.assert_array_equal(got, want)


def test_mutation_counts_jit_on_mesh():
    """The same reduction over a bank word-sharded on the 8-device mesh
    (XLA inserts the cross-device sum)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from lapis_silo_tpu.ops.reductions import _mutation_counts_jit
    from lapis_silo_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual multi-device mesh")
    mesh = make_mesh()
    rng = np.random.default_rng(13)
    bank = rng.integers(0, 2**32, size=(24, 8 * 260), dtype=np.uint32)
    filters = rng.integers(0, 2**32, size=bank.shape[1], dtype=np.uint32)
    bank_d = jax.device_put(bank, NamedSharding(mesh,
                                                PartitionSpec(None, "seq")))
    filt_d = jax.device_put(filters, NamedSharding(mesh,
                                                   PartitionSpec("seq")))
    got = np.asarray(_mutation_counts_jit(bank_d, filt_d, 4, 16))
    want = (np.bitwise_count(bank[4:20] & filters[None, :])
            .sum(axis=1).astype(np.int32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sharded", [False, True])
def test_sparse_mutation_counts_matches_numpy(sharded):
    """Segmented sparse popcount over the combined stream vs numpy: per
    leaf, the sum over its partition segments of popcount(word &
    filter[idx]); the mesh form splits the entry axis and psums."""
    from lapis_silo_tpu.ops import reductions

    if sharded and len(jax.devices()) < 8:
        pytest.skip("needs the virtual multi-device mesh")
    rng = np.random.default_rng(19)
    k, p, n_words = 7, 4, 16 * 128
    segments = _segments("ragged", rng, k * p, p, n_words)
    comb, starts, lens, idx, words = _stream(segments, rng)
    filters = rng.integers(0, 2**32, size=n_words, dtype=np.uint32)
    want = np.zeros(k, np.int64)
    for g in range(k * p):
        s, n = starts[g], lens[g]
        want[g // p] += int(np.bitwise_count(
            words[s:s + n] & filters[idx[s:s + n]]).sum())
    if sharded:
        from jax.sharding import NamedSharding, PartitionSpec
        from lapis_silo_tpu.parallel.mesh import make_mesh
        from lapis_silo_tpu.ops import sparse_stream as ss

        mesh = make_mesh()
        n_dev = mesh.devices.size
        e = comb.shape[0] * 64
        e_pad = -(-e // (ss.COMBINE_BLOCK * n_dev)) * ss.COMBINE_BLOCK * n_dev
        idx_p, wrd_p = ss.split_stream(comb)
        idx_p = np.concatenate([idx_p, np.zeros(e_pad - e, np.int32)])
        wrd_p = np.concatenate([wrd_p, np.zeros(e_pad - e, np.uint32)])
        comb = ss.combine_stream(idx_p, wrd_p)
        run = reductions._sparse_mutation_counts_sharded_jit(mesh, p)
        got = run(jnp.asarray(comb),
                  jax.device_put(filters, NamedSharding(
                      mesh, PartitionSpec("seq"))),
                  jnp.asarray(starts), jnp.asarray(lens))
    else:
        got = reductions._sparse_mutation_counts_jit(
            jnp.asarray(comb), jnp.asarray(filters), jnp.asarray(starts),
            jnp.asarray(lens), p)
    np.testing.assert_array_equal(np.asarray(got, dtype=np.int64), want)
