"""Multi-process pod-path worker (tests/test_jax_distributed.py).

Each process owns 4 virtual CPU devices; jax.distributed joins them into
one global mesh. The filter-VM step runs with the packed word axis sharded
across ALL devices (both processes) — the same program a real multi-host
multi-host deployment runs, with XLA collectives crossing the (here: in-memory) DCN.

Usage: python distributed_worker.py <port> <num_processes> <process_id>
"""

import os
import sys

port, num_processes, process_id = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=num_processes,
    process_id=process_id,
)

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from lapis_silo_tpu.ops import device_engine as de  # noqa: E402
from lapis_silo_tpu.parallel.mesh import ShardedQueryStep, make_mesh  # noqa: E402

n_devices = jax.device_count()
assert n_devices == 4 * num_processes, (n_devices, num_processes)

# Deterministic inputs, identical in every process (flat global word axis:
# partitions fold into words).
P_, R, LEN = 2, 64, 16
PW = P_ * 4 * n_devices
rng = np.random.default_rng(0)
bank = rng.integers(0, 1 << 32, size=(R, PW), dtype=np.uint32)
dyn = np.zeros((1, PW), dtype=np.uint32)
full = np.full(PW, 0xFFFFFFFF, dtype=np.uint32)
# reg0 = bank[3]; reg0 &= bank[7]
code = de.pack_code_array(
    LEN, [de.ALU, de.ALU], [3, 7],
    [0 | (de.M_MOVB << 24) | (de.B_BANK << 28),
     0 | (0 << 8) | (de.M_AND << 24) | (de.B_BANK << 28)])

mesh = make_mesh(jax.devices())
step = ShardedQueryStep(mesh, n_partitions=P_, n_rows=R, n_dyn=1, n_words=PW,
                        program_len=LEN)


def put(host, spec):
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


args = (
    put(code, PartitionSpec()),
    put(bank, PartitionSpec(None, "seq")),
    put(dyn, PartitionSpec(None, "seq")),
    put(full, PartitionSpec("seq")),
)
words, count, mutation_counts = step(*args)
jax.block_until_ready(words)
if process_id == 0:
    print(f"RESULT count={int(count)} mut={int(np.asarray(mutation_counts).sum())}",
          flush=True)
