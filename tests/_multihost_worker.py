"""Worker for the true multi-process jax.distributed tests/benchmarks (see
test_parallel_multiproc.py and ``bench.py --multiproc``). Each process owns
2 virtual CPU devices; the global (chain, g) mesh spans the processes with
the g axis inside one process (the layout doctrine of
parallel/multihost.py) and the chain axis data-parallel across processes.

argv: pid port [nprocs n_chains iters K N G] [--bench]
Defaults reproduce the original correctness test (2 procs, 4 chains,
3 iterations at 8x2x8). ``--bench`` times a second (compiled) chunk and
prints ``WORKER_TPS pid=<pid> tps=<chain-iters/sec>``.
"""

import os
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    pid = int(sys.argv[1])
    port = sys.argv[2]
    args = [a for a in sys.argv[3:] if not a.startswith("--")]
    nprocs = int(args[0]) if len(args) > 0 else 2
    n_chains = int(args[1]) if len(args) > 1 else 4
    iters = int(args[2]) if len(args) > 2 else 3
    K, N, G = (map(int, args[3:6])) if len(args) > 5 else (8, 2, 8)
    bench = "--bench" in sys.argv

    from bayesnmf_tpu.parallel import multihost as MH

    ok = MH.initialize(f"127.0.0.1:{port}", num_processes=nprocs,
                       process_id=pid)
    assert ok, "distributed bootstrap failed"
    assert jax.process_count() == nprocs, jax.process_count()
    assert len(jax.devices()) == 2 * nprocs, len(jax.devices())

    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
    from bayesnmf_tpu.parallel import chains as C

    # bench mode: pure chain-dp (chains across processes, g inside one) —
    # the layout whose compiled hot loop provably has no collectives
    # (test_parallel.py::test_chain_dp_hot_loop_has_no_collectives)
    if bench:
        mesh = MH.global_mesh(n_chain=2 * nprocs, n_g=1)
    else:
        mesh = MH.global_mesh(n_chain=nprocs, n_g=2)
    rng = np.random.default_rng(0)
    P = rng.gamma(2.0, 1.0, (K, N))
    E = rng.gamma(2.0, 1.0, (N, G))
    data_np = rng.poisson(P @ E).astype(np.float32)
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson", prior="truncnormal",
                     MH=True)
    hp = default_hyperprior_params(spec, float(data_np.mean()))
    data = MH.shard_data(data_np, mesh)

    init, run = C.make_sharded_chain_runner(spec, mesh, n_chains,
                                            record="metrics")
    states = init(hp, data, jax.random.PRNGKey(0))
    temps = jnp.ones((iters,), jnp.float32)
    acc = jnp.zeros((n_chains,), bool)
    states, samples = run(data, hp, states, temps, acc)

    # cross-process gather of the chain-sharded metrics proves the DCN path
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(
        samples["metrics"], tiled=True)
    arr = np.asarray(gathered)
    ll = arr.reshape(-1, arr.shape[-2], arr.shape[-1])[:, -1, 3]
    assert np.isfinite(ll).all(), ll

    if bench:
        # timed, compiled chunk with global barriers around it
        multihost_utils.sync_global_devices("bench_start")
        t0 = time.perf_counter()
        states, samples = run(data, hp, states, temps, acc)
        np.asarray(samples["metrics"].addressable_shards[0].data)
        multihost_utils.sync_global_devices("bench_end")
        dt = time.perf_counter() - t0
        print(f"WORKER_TPS pid={pid} tps={n_chains * iters / dt:.2f}",
              flush=True)
    print(f"WORKER_OK pid={pid} ll0={ll[0]:.3f}", flush=True)


if __name__ == "__main__":
    main()
