"""PyTorch port: the sharded schedules across processes and the dry runs
of `parallel.dryrun`, on the CPU.

`dryrun_multiprocess(2, 2)` starts two processes of two shards each in
one Gloo group and holds each process's shards to its own single-device
run at 1e-12 (the JAX package's tests/test_multiprocess.py, there over
jax.distributed). Two such dry runs run at once here: each meets through a
FileStore of its own, so they share no port. A worker that cannot finish
is killed with its siblings. The in-process NCCL group of one rank
holding four shards, and the dry run with its shards on the card, need a
card (`cuda` marker) and skip here.
"""

import subprocess
import threading

import pytest

torch = pytest.importorskip("torch")

from cyclistsocialforce_tpu_torch.parallel import dryrun  # noqa: E402

torch.set_num_threads(1)


def test_dryrun_multiprocess_two_at_once(capsys):
    errors = []

    def one():
        try:
            dryrun.dryrun_multiprocess(2, 2, "cpu")
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    out = capsys.readouterr().out
    assert out.count("dryrun_multiprocess(2 procs x 2 shards, cpu): ok") == 2
    # both workers of both runs passed both checks
    assert out.count("-> ok") == 8, out


def test_dryrun_multichip_cpu(capsys):
    dryrun.dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out
    assert out.count("-> ok") == 7, out
    assert "FAIL" not in out


def test_a_stuck_worker_is_killed(monkeypatch):
    """One worker of a two-process group started alone waits for its
    peer: at the timeout it is killed, and no process outlives the
    call."""
    started = []
    real = subprocess.Popen

    def popen(*args, **kw):
        started.append(real(*args, **kw))
        return started[-1]

    monkeypatch.setattr(dryrun.subprocess, "Popen", popen)
    with pytest.raises(subprocess.TimeoutExpired):
        dryrun.run_workers(["cyclistsocialforce_tpu_torch.parallel.dryrun",
                            "--worker", "2", "2", "cpu"], 1, timeout=5)
    assert len(started) == 1
    assert started[0].poll() is not None       # killed and reaped


def test_nccl_needs_a_card_per_rank():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("this machine has 64 cards")
    with pytest.raises((ValueError, RuntimeError), match="card|CUDA"):
        dryrun.dryrun_multiprocess(64, 1, "cuda")


@pytest.mark.cuda
def test_in_process_nccl_group_equals_in_process_mesh():
    """One NCCL rank created in-process holding four shards: the culled
    allgather schedule through the group's all_gather, bit-equal to the
    same mesh without a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an NCCL group has no CPU mode)")
    import torch.distributed as dist

    from cyclistsocialforce_tpu_torch import Engine, NeighborConfig
    from cyclistsocialforce_tpu_torch.models import MODELS
    from cyclistsocialforce_tpu_torch.params import BicycleParams
    from cyclistsocialforce_tpu_torch.parallel import (
        make_mesh, shard_state, sharded_simulate_fn)
    from cyclistsocialforce_tpu_torch.scenarios import build_population

    st = build_population(4096, 0.02, 8, 512, torch.float32, "cuda")
    eng = Engine.create(BicycleParams.create(), MODELS["bicycle2d"],
                        rep_force="twod", neighbors=NeighborConfig(
                            cutoff=50.0, block=128, block_src=64, kb=19,
                            rebuild_every=20))

    def run(mesh):
        final, _ = sharded_simulate_fn(eng, mesh, 45)(shard_state(st, mesh))
        return torch.cat([f.s for f in final])

    want = run(make_mesh(4, device="cuda"))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got = run(make_mesh(4, group=dist.group.WORLD, device="cuda"))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(capsys):
    """Every check of the dry run with the shards on the card (the culled
    pairs through K1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode)")
    dryrun.dryrun_multichip(4, "cuda")
    out = capsys.readouterr().out
    assert out.count("-> ok") == 7, out
