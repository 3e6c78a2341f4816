"""Multi-host bring-up and scaling measurement.

The reference has no distributed layer (single-node rayon; SURVEY §2.3).
Scale-out here follows the standard JAX recipe:

  1. every process calls `initialize_multihost()` (jax.distributed)
     with the coordinator address, the process count and its own id;
  2. build the global ("data",) mesh over all devices;
  3. each host feeds its local shard of the sequence/query batch
     (jax.make_array_from_process_local_data);
  4. the jitted steps in pgrtk.parallel.mesh handle cross-device
     reduction (psum) and hit merging (all_gather); XLA hands the
     collectives to NCCL (NVLink within a host, the network across).

The index is replicated per device in v1 (the HPRC-year-1 .mdb fits in
device memory); v2 shards it by hash range (parallel/mesh.py).

NOTE: measure_index_scaling on a virtual CPU mesh
(xla_force_host_platform_device_count) measures correctness of the
sharded program, not real scaling — the virtual devices share the same
physical cores.  Run it on real devices for the BASELINE scaling target
(>= 0.8 weak-scaling efficiency 1 -> 4 hosts).
"""
from __future__ import annotations

import time

import numpy as np


def initialize_multihost(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Initialize the JAX distributed runtime for a multi-process GPU
    launch.  Nothing in a plain GPU environment tells JAX of the cluster,
    so every process passes the coordinator's "host:port" (process 0
    listens there), the number of processes, and its own id in
    [0, num_processes)."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def measure_index_scaling(
    device_counts,
    per_device_batch: int = 2,
    seq_len: int = 1 << 18,
    iters: int = 5,
):
    """Measure sharded-index-step throughput at several mesh sizes.

    Weak scaling: the per-device batch is constant, so ideal scaling keeps
    time flat while total bases grow with the mesh.  Returns
    [(n_devices, total_bases, seconds_per_step, bases_per_second)].
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from . import mesh as pmesh

    results = []
    for n in device_counts:
        mesh = pmesh.make_mesh(n)
        axis = mesh.axis_names[0]
        B = per_device_batch * n
        rng = np.random.default_rng(0)
        seqs = rng.integers(0, 4, size=(B, seq_len), dtype=np.uint8)
        shard = NamedSharding(mesh, P(axis, None))
        shard1 = NamedSharding(mesh, P(axis))
        sd = jax.device_put(jnp.asarray(seqs), shard)
        ld = jax.device_put(
            jnp.full(B, seq_len, dtype=jnp.int32), shard1
        )
        rd = jax.device_put(jnp.arange(B, dtype=jnp.uint32), shard1)
        step = pmesh.sharded_sketch_index_step(mesh, chunk=512)
        out = step(sd, ld, rd)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(iters):
            out = step(sd, ld, rd)
        jax.block_until_ready(out)
        _ = int(out["n_pairs"])  # host sync on the result
        dt = (time.time() - t0) / iters
        total = B * seq_len
        results.append((n, total, dt, total / dt))
    return results


def scaling_efficiency(results) -> float:
    """Weak-scaling efficiency from measure_index_scaling results:
    throughput(N) / (N * throughput(1))."""
    if len(results) < 2:
        return 1.0
    n0, _, _, r0 = results[0]
    nN, _, _, rN = results[-1]
    return (rN / nN) / (r0 / n0)
