"""Rank processes for the port's multi-process CPU tests (gloo).

``run_ranks(world, jobs, work)`` starts ``world`` copies of this file
with the environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; the ranks on ``nodes`` nodes of equal size, one node by
default), waits for them with a timeout and returns rank 0's results
(with ``every_rank``, every rank's, in rank order). Each rank joins the
process group through the train entry point's ``init_distributed`` and
runs every job
of ``jobs`` in turn: it builds a ``NetworkFactory`` on the CPU from the
job's settings and archive, loads the job's state dict if any, then
either takes the job's steps (global host batches or global resident
index vectors, with the global batch's draws) or runs
``begin_training`` (with ``stop_rank``, that rank asks to stop before
the first step; with ``record_rows``, each rank records the host rows
it trains at each step). Rank 0 records the losses, the first step's
gradients, the state after the first step and the final state, in the
plain layout (model-axis shards gathered); with ``profile``, the job's
steps run under a CPU ``torch.profiler`` and rank 0 records the names
of the port's spans (``scd.*``) in its trace. With ``again``, each rank
then builds a second factory of the same settings and rank 0 records
whether it took the first one's process groups and how many groups it
made. A job of ``"kind": "skip"`` instead runs one all-reduce on the
data line of a mesh ``[world]``, which rank ``skip_rank`` leaves out:
rank 0 records what its wait raised and after how long, and the
skipping rank stays up until then. Ranks import no JAX.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240  # every rank of a launch, start-up included
COLLECTIVE_TIMEOUT_S = 60.0  # a hung collective fails after this


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(world: int, jobs, work: str,
              collective_timeout_s: float = COLLECTIVE_TIMEOUT_S,
              timeout_s: float = TIMEOUT_S, nodes: int = 1,
              every_rank: bool = False):
    """Run ``jobs`` on ``world`` gloo ranks, ``world / nodes`` a node,
    whose collectives fail after ``collective_timeout_s``; rank 0's
    results by job name (``every_rank``: a list of every rank's). A rank
    that fails or outlives ``timeout_s`` fails the call."""
    import torch

    os.makedirs(work, exist_ok=True)
    spec = os.path.join(work, "jobs.pt")
    torch.save({"jobs": jobs, "timeout_s": collective_timeout_s,
                "every_rank": every_rank}, spec)
    local = world // nodes
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               LOCAL_WORLD_SIZE=str(local), MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for rank in range(world):
        log = open(os.path.join(work, "rank{}.log".format(rank)), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, work],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank % local),
                     GROUP_RANK=str(rank // local)),
            stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    deadline = time.monotonic() + timeout_s
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                if proc.wait(timeout=max(deadline - time.monotonic(),
                                         0.1)) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        tails = []
        for rank in failed:
            with open(os.path.join(work, "rank{}.log".format(rank))) as f:
                tails.append("rank {}:\n{}".format(rank, f.read()[-3000:]))
        raise RuntimeError("ranks {} failed:\n{}".format(failed,
                                                         "\n".join(tails)))
    if every_rank:
        return [torch.load(os.path.join(work, "results{}.pt".format(rank)),
                           weights_only=False) for rank in range(world)]
    return torch.load(os.path.join(work, "results0.pt"), weights_only=False)


def _skip_all_reduce(job, rank: int, work: str):
    """One all-reduce on the data line of a mesh ``[world]`` (this
    rank's group of ``create_mesh``), left out by ``job["skip_rank"]``;
    that rank waits until rank 0 has written ``skip.done`` (at most a
    minute), so rank 0's wait ends by the group's timeout and not by a
    peer that left."""
    import torch
    import torch.distributed as dist

    from scd_resnet_tpu_torch.parallel.collectives import reduce_sum_
    from scd_resnet_tpu_torch.parallel.mesh import create_mesh

    group = create_mesh(("data",), (dist.get_world_size(),)).group("data")
    done = os.path.join(work, "skip.done")
    if rank == job["skip_rank"]:
        deadline = time.monotonic() + 60
        while not os.path.exists(done) and time.monotonic() < deadline:
            time.sleep(0.05)
        return {}
    t0 = time.perf_counter()
    try:
        reduce_sum_(torch.ones(1), group)
        raised = None
    except RuntimeError as err:
        raised = str(err)
    out = {"raised": raised, "seconds": time.perf_counter() - t0}
    with open(done, "w"):
        pass
    return out


def _run_job(job, rank: int):
    import contextlib

    import torch

    from scd_resnet_tpu_torch.core.config import Configuration
    from scd_resnet_tpu_torch.data.dataset import SCDDataset
    from scd_resnet_tpu_torch.parallel.mesh import (
        full_checkpoint_state,
        full_gradients,
    )
    from scd_resnet_tpu_torch.train.factory import NetworkFactory

    settings = {k: v.format(rank=rank) if isinstance(v, str) else v
                for k, v in job["settings"].items()}
    for key in ("dirTemp", "dirResult"):
        os.makedirs(settings[key], exist_ok=True)
    cfg = Configuration()
    cfg.update_config(settings)
    dataset = SCDDataset(job["archive"], None, test_set=4, seed=42,
                         device="cpu")
    factory = NetworkFactory(cfg, dataset=dataset, device="cpu")
    if job.get("state") is not None:
        state = torch.load(job["state"])
        if factory.sharded:
            from scd_resnet_tpu_torch.parallel.mesh import local_checkpoint_state

            state, _ = local_checkpoint_state(
                factory.model, state, {"state": {}, "param_groups": []},
                factory.sharded, factory.mesh)
        factory.model.load_state_dict(state)
    out = {"losses": [], "sharded": dict(factory.sharded),
           "resident": factory.resident}
    if job.get("again"):
        import torch.distributed as dist

        new_group, made = dist.new_group, []
        dist.new_group = lambda *a, **k: made.append(1) or new_group(*a, **k)
        try:
            again = NetworkFactory(cfg, dataset=dataset, device="cpu")
        finally:
            dist.new_group = new_group
        out["again"] = {"groups_made": len(made),
                        "same_data_group": again.data_group is not None
                        and again.data_group is factory.data_group,
                        "same_host_group": again._host_group is not None
                        and again._host_group is factory._host_group}
    if job.get("record_rows"):
        train_rows = factory.train_rows
        out["rows"] = []

        def recording(samples, locs, counts, draws=None):
            out["rows"].append((samples.copy(), locs.copy(), counts.copy()))
            return train_rows(samples, locs, counts, draws)

        factory.train_rows = recording
    if job.get("begin_training"):
        if job.get("stop_rank") == rank:
            factory.request_stop()
        out["summary"] = factory.begin_training()
        out["preempted"] = factory.preempted
    profiler = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) \
        if job.get("profile") else contextlib.nullcontext()
    for k, step in enumerate(job.get("steps", [])):
        with profiler if k == 0 else contextlib.nullcontext():
            if "idx" in step:
                loss, stats = factory.train_resident(step["idx"],
                                                     draws=step.get("draws"))
            else:
                loss, stats = factory.train(*step["batch"],
                                            draws=step.get("draws"))
        out["losses"].append([loss.item()] + [s.item() for s in stats])
        if k == 0:
            out["grads"] = {k: g.clone() for k, g in full_gradients(
                factory.model, factory.sharded, factory.mesh).items()}
            first, _ = full_checkpoint_state(
                factory.model, factory.optimizer, factory.sharded,
                factory.mesh)
            out["first_state"] = {k: v.clone() for k, v in first.items()}
    if job.get("profile"):
        out["spans"] = [e.name for e in profiler.events()
                        if e.name.startswith("scd.")]
    state, opt = full_checkpoint_state(factory.model, factory.optimizer,
                                       factory.sharded, factory.mesh)
    out["state"] = {k: v.clone() for k, v in state.items()}
    out["optimizer"] = opt
    if job.get("save"):
        factory.save_parameters(job["save"])
    return out


def main(spec: str, work: str) -> None:
    import torch

    from scd_resnet_tpu_torch.parallel.mesh import init_distributed

    spec = torch.load(spec, weights_only=False)
    rank, _, _ = init_distributed("cpu", timeout_s=spec["timeout_s"])
    # one thread a rank: a test's ranks share the cores of one test worker
    torch.set_num_threads(1)
    results = {job["name"]: _skip_all_reduce(job, rank, work)
               if job.get("kind") == "skip" else _run_job(job, rank)
               for job in spec["jobs"]}
    if rank == 0 or spec["every_rank"]:
        torch.save(results, os.path.join(work, "results{}.pt".format(rank)))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
