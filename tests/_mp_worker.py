"""Worker for the 2-process distributed tests (see test_multiprocess.py).

Each process brings up jax.distributed via ``mesh.init_distributed`` (the
multi-host entry point), contributes 4 virtual CPU
devices to an 8-device global mesh, and runs a RowShardedSpmv across both
processes; each process validates the y rows its own devices produced
against the fp64 oracle.

Usage: _mp_worker.py <coordinator> <num_processes> <process_id>
                     [format] [nrows] [gather_x]
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    coordinator, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    fmt = sys.argv[4] if len(sys.argv) > 4 else "cmrs"
    nrows = int(sys.argv[5]) if len(sys.argv) > 5 else 1024
    gather_x = (sys.argv[6] != "0") if len(sys.argv) > 6 else True

    import jax

    jax.config.update("jax_platforms", "cpu")

    from spmv_tpu.dist.mesh import init_distributed, make_mesh

    init_distributed(coordinator=coordinator, num_processes=nproc,
                     process_id=pid)

    import numpy as np

    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    from spmv_tpu import synth
    from spmv_tpu.dist.sharded import RowShardedSpmv
    from spmv_tpu.oracle import golden_spmv

    info, r, c, v = synth.synthetic_cant(n=nrows, avg_nnz_per_row=8,
                                         bandwidth=60, seed=11)
    x = np.random.default_rng(3).standard_normal(info.ncols).astype(np.float32)

    mesh = make_mesh(len(jax.devices()))
    a = RowShardedSpmv(fmt, info.nrows, info.ncols, r, c, v, mesh,
                       gather_x=gather_x)
    y = a.matvec(x)  # global sharded jax.Array

    expected = golden_spmv(info.nrows, r, c, v, x)
    scale = golden_spmv(info.nrows, r, c, np.abs(v), np.abs(x))
    bad = 0
    checked = 0
    for shard in y.addressable_shards:
        sl = shard.index[0]
        got = np.asarray(shard.data).reshape(-1)
        exp = expected[sl]
        tol = 1e-4 + 1e-4 * scale[sl]
        bad += int((np.abs(got - exp) > tol).sum())
        checked += exp.size
    assert checked > 0, "process validated no rows"
    assert bad == 0, f"{bad}/{checked} mismatches on process {pid}"
    print(f"proc {pid}: validated {checked} local rows of {fmt} "
          f"(nrows={info.nrows}, gather_x={gather_x}) over "
          f"{jax.process_count()} processes OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
