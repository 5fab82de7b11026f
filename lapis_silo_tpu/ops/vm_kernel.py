"""The filter VM as a CUDA kernel (native/silo_vm.cu), called through
jax.ffi on the GPU.

The kernel runs the same register machine as the XLA interpreter
(vm.build_run_one_with_emit) in one launch: the word axis is tiled over
blocks, the register file of a tile lives in shared memory, and a batch's
instruction stream is split at query boundaries over a second grid axis.
This module builds the library from the committed source with nvcc (into
native/build/, keyed by the source's hash), registers the FFI target, and
wraps the call: the query-boundary split is computed on device from the
instruction stream itself, so the upload is the same blob the XLA path
takes.

`reference_call` is a jnp model of the kernel's contract (chunks of the
stream run from zeroed registers, partial counts summed, words from the
last chunk); the CPU tests substitute it for the FFI call to check the
wrapper's chunking and padding without a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from . import vm

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "silo_vm.cu")
BUILD_DIR = os.path.join(_REPO, "native", "build")
TARGET = "silo_vm_run"

# the word axis of every row must split into 16-byte vectors (one per
# thread); DeviceEngine pads each device's share of the flat axis to this
WORD_QUANTUM = 4
# words a block owns (kTileWords in the source): 128 threads x 4 words
TILE_WORDS = 512
# the batch splits until about this many blocks are in flight: 132 SMs,
# several resident blocks each
TARGET_BLOCKS = 2048
MAX_CHUNKS = 256

_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("the GPU filter VM needs nvcc (CUDA toolkit) to build "
                       f"{SOURCE}; none found on PATH or in /usr/local/cuda")


def library_path() -> str:
    """native/build/libsilo_vm-<hash>.so: the hash covers the source and
    the compile flags, so an edited source never loads a stale build."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libsilo_vm-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library unless this source's build exists."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-I", jax.ffi.include_dir(),
           "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return path


def ensure_registered() -> None:
    """Build (if needed), load and register the FFI target once per
    process; must precede tracing any call."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SiloVmRun),
                                    platform="CUDA")
        _registered = True


def n_chunks_for(n_words: int) -> int:
    """Batch chunks for a word axis of n_words: enough block rows that
    tiles x chunks reaches TARGET_BLOCKS."""
    n_tiles = -(-n_words // TILE_WORDS)
    return max(1, min(MAX_CHUNKS, -(-TARGET_BLOCKS // n_tiles)))


def chunk_bounds(packed, n_instr, n_chunks: int):
    """int32[n_chunks + 1] instruction offsets splitting the first n_instr
    instructions into n_chunks runs of whole queries. A query starts at 0
    and after every EMIT_COUNT; each chunk takes an equal share of the
    queries, and the last chunk always holds the last one."""
    length = packed.shape[0]
    if n_chunks == 1:
        return jnp.stack([jnp.int32(0), n_instr.astype(jnp.int32)])
    idx = jnp.arange(length, dtype=jnp.int32)
    after_emit = jnp.concatenate([
        jnp.zeros(1, bool),
        ((packed[:-1] >> vm.WIRE_OP_SHIFT) & 0x3) == vm.EMIT_COUNT])
    is_start = ((idx == 0) | after_emit) & (idx < n_instr)
    size = min(length, vm.MAX_BATCH_QUERIES + 1)
    starts = jnp.nonzero(is_start, size=size, fill_value=n_instr)[0]
    starts = jnp.concatenate([starts.astype(jnp.int32),
                              n_instr.astype(jnp.int32).reshape(1)])
    n_q = jnp.minimum(is_start.sum(dtype=jnp.int32), size)
    pick = (jnp.arange(n_chunks + 1, dtype=jnp.int32) * n_q) // n_chunks
    return starts[pick]


def _ffi_call(operands, packed, bounds, bank, dyn, sparse, full, n_regs):
    return jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct(full.shape, jnp.uint32),
         jax.ShapeDtypeStruct((vm.MAX_BATCH_QUERIES,), jnp.int32)),
    )(operands, packed, bounds, bank, dyn, sparse, full,
      n_regs=np.int32(n_regs))


def reference_call(operands, packed, bounds, bank, dyn, sparse, full,
                   n_regs):
    """The kernel's contract in jnp: every chunk runs from zeroed
    registers, EMIT counts add up over chunks, words come from the last
    chunk."""
    n_rows, n_dyn, n_k = bank.shape[0], dyn.shape[0], sparse.shape[0]
    run = vm.build_run_one_with_emit(
        operands.shape[0], n_rows, n_dyn, full.shape[0], n_sparse_k=n_k,
        n_regs=n_regs, unroll=1)
    code = jnp.stack([operands, packed])
    counts = jnp.zeros((vm.MAX_BATCH_QUERIES,), jnp.int32)
    words = None
    for c in range(bounds.shape[0] - 1):
        words, part = run(code, bank, dyn, sparse, full, bounds[c + 1],
                          start=bounds[c])
        counts = counts + part
    return words, counts


# the function the wrapper calls (reference_route substitutes the model)
kernel_call = _ffi_call


@contextlib.contextmanager
def reference_route(max_chunks: int = 4):
    """Run the GPU path — vm_path() == 'kernel', this wrapper, its
    shard_map form — on any backend, with reference_call standing in for
    the CUDA kernel: how the CPU tests and the multi-device dry run
    exercise the wrapper's chunking, padding and sharding. `max_chunks`
    bounds the chunk count (the model traces one loop per chunk)."""
    global kernel_call, MAX_CHUNKS, ensure_registered
    saved = (vm.vm_path, ensure_registered, kernel_call, MAX_CHUNKS)

    def clear():
        vm._interpreter.cache_clear()
        vm._pooled_update_vm_jit.cache_clear()
        _sharded.cache_clear()

    vm.vm_path = lambda: "kernel"
    ensure_registered = lambda: None  # noqa: E731
    kernel_call = reference_call
    MAX_CHUNKS = max_chunks
    clear()
    try:
        yield
    finally:
        vm.vm_path, ensure_registered, kernel_call, MAX_CHUNKS = saved
        clear()


def vm_run(code, n_instr, bank, dyn, sparse, full, n_regs: int,
           split: bool):
    """(words [PW] = reg[0], counts [MAX_BATCH_QUERIES]) for one device's
    word range. `split` lets a multi-query batch spread over block rows;
    single-program outputs (words, count, compact) keep one chunk."""
    n_words = full.shape[0]
    if n_words % WORD_QUANTUM:
        raise ValueError(f"word axis {n_words} is not a multiple of "
                         f"{WORD_QUANTUM}")
    n_chunks = n_chunks_for(n_words) if split else 1
    bounds = chunk_bounds(code[1], n_instr, n_chunks)
    return kernel_call(code[0], code[1], bounds, bank, dyn, sparse, full,
                       n_regs)


@functools.lru_cache(maxsize=None)
def _sharded(mesh, n_regs: int, split: bool):
    from jax.sharding import PartitionSpec as P

    def local(code, n_instr, bank, dyn, sparse, full):
        words, counts = vm_run(code, n_instr, bank, dyn, sparse, full,
                               n_regs, split)
        return words, jax.lax.psum(counts, "seq")

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(None, "seq"), P(None, "seq"), P(None, "seq"),
                  P("seq")),
        out_specs=(P("seq"), P()), check_vma=False)


def vm_run_sharded(mesh, code, n_instr, bank, dyn, sparse, full,
                   n_regs: int, split: bool):
    """vm_run over a word-sharded mesh: every device runs the kernel on its
    own word shard (the VM is word-local), EMIT counts merge with one
    psum."""
    return _sharded(mesh, n_regs, split)(code, n_instr, bank, dyn, sparse,
                                         full)
