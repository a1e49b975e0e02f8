"""tpu_sdr_torch.parallel.distributed: two processes joined by gloo on
127.0.0.1, the port's counterpart of tests/test_multihost.py.

Each process owns a ``(1, 2)`` row of CPU shards of the ``(2, 2)`` host
mesh and feeds only its own station's bytes; the sharded float chain's
halos stay inside each process; rank 0 gathers the audio and holds it
against the port's serial float chain.  No JAX here or in the workers:
this file is also the worker, run as

    python tests/test_torch_distributed.py <rank> <world> <port> <out_dir>
"""

import os
import socket
import subprocess
import sys

N_LOC = 2040 * 12  # complex per shard: aligned (n_out % 85 == 0)
SP = 2


def _station(rank: int):
    import numpy as np

    rng = np.random.default_rng(100 + rank)
    return rng.integers(0, 256, size=(1, 2 * N_LOC * SP), dtype=np.uint8)


def worker(rank: int, world: int, port: int, out_dir: str) -> int:
    import numpy as np
    import torch

    from tpu_sdr_torch.models import wbfm
    from tpu_sdr_torch.parallel import distributed as dist
    from tpu_sdr_torch.parallel.wbfm_sharded import make_sharded_wbfm
    from tpu_sdr_torch.utils.design import WbfmConfig

    torch.set_num_threads(1)
    dist.init_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                          device_type="cpu")
    mesh = dist.make_host_mesh(["cpu"] * SP)
    assert mesh.shape == {"dp": world, "sp": SP}
    assert mesh.local_rows() == [rank]
    config = WbfmConfig()
    chain = make_sharded_wbfm(mesh, config)
    audio, counts = dist.multihost_wbfm_apply(chain, _station(rank))
    assert all(audio[r] is None for r in range(world) if r != rank)
    got = dist.fetch_global(torch.from_numpy(chain.assemble(audio, counts)))
    if rank == 0:
        params = wbfm.WbfmParams(config, torch.device("cpu"))
        exp = np.stack([wbfm.demodulate_block(
            torch.from_numpy(_station(r)[0]),
            wbfm.init_state(config, torch.device("cpu")), params,
            config)[0].numpy() for r in range(world)])
        assert got.shape == exp.shape, (got.shape, exp.shape)
        np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)
        with open(os.path.join(out_dir, "ok"), "w") as f:
            f.write(f"shape={got.shape}")
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_wbfm(tmp_path):
    port = _free_port()
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPU_SDR_PLATFORM", "PYTEST_CURRENT_TEST")}
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port),
         str(tmp_path)], env=env, cwd=repo_root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {rank} rc={p.returncode}\n{out[-4000:]}")
    assert (tmp_path / "ok").exists(), "rank 0 never validated the audio"


if __name__ == "__main__":
    sys.exit(worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                    sys.argv[4]))
