"""Worker process for the 2-process multi-host pipeline test.

Usage: python multihost_worker.py <coordinator> <nprocs> <pid> <stream> <out>

Each process contributes 4 virtual CPU devices; the block batch shards over
the global 8-device mesh across BOTH processes, and the host-0-only ordered
assembly (pipeline._to_host0) plays the upstream writer-thread role over
the process boundary — the real jax.distributed code path, not a
simulation.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    coordinator, nprocs, pid, stream_path, out_path = sys.argv[1:6]
    from turbosqueeze_tpu.parallel import mesh as mesh_mod
    from turbosqueeze_tpu.parallel import pipeline

    mesh_mod.init_distributed(coordinator, int(nprocs), int(pid))
    assert jax.process_count() == int(nprocs), jax.process_count()
    assert len(jax.devices()) == 4 * int(nprocs), len(jax.devices())

    stream = open(stream_path, "rb").read()
    # file path: PER-HOST ordered writes — each process writes its own
    # shards at their block offsets; no host gathers another's bytes
    pipeline.decompress_to_file(stream, out_path + ".perhost")
    # memory path: shard-local host copies + HOST-0-ONLY assembly — each
    # nonzero rank sends its shard once and must NOT hold the output
    out = pipeline.decompress(stream)
    if jax.process_index() == 0:
        assert out == open(out_path + ".perhost", "rb").read()
        with open(out_path, "wb") as f:
            f.write(out)
    else:
        assert out == b"", "nonzero rank must not hold the decoded output"
    # compress across both processes: shard-local block packing
    # (_device_put_rows), sharded candidate search, ordered gather.
    # (Every rank needs the plaintext input; rank 1's memory-path result
    # is empty by contract, so both read the per-host file.)
    data = open(out_path + ".perhost", "rb").read()
    restream = pipeline.compress(data, ext=True, level=1)
    if jax.process_index() == 0:
        with open(out_path + ".tsq2", "wb") as f:
            f.write(restream)
    # measure the chunked host-0 KV assembly hop in isolation (the
    # coordination-service data hop is bounded at _HOST0_CHUNK per value;
    # this records its actual throughput so deployments can size against
    # it). 32 MiB block-sharded across both hosts.
    import time

    import numpy as np

    m = mesh_mod.block_mesh()
    rows = np.arange(32 << 18, dtype=np.int32).reshape(64, -1, 128)
    sh = mesh_mod.block_sharding(m)
    arr = jax.make_array_from_callback(
        rows.shape, sh, lambda idx: rows[idx])
    got = pipeline._to_host0(arr)  # warm the path once
    t0 = time.perf_counter()
    got = pipeline._to_host0(arr)
    dt = time.perf_counter() - t0
    if jax.process_index() == 0:
        assert np.array_equal(got, rows), "host-0 KV assembly corrupted"
        print(f"KV_HOST0_MBPS {rows.nbytes / 2 / dt / 1e6:.1f}",
              flush=True)  # nonzero ranks ship half the bytes
    else:
        assert got is None
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
