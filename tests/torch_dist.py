"""Run a function of this module on N ranks of the port, one process each.

    results = run("step_cases", world_size=2, cases=[...])  # one result per rank

The parent pickles the function's name and keyword arguments to a file; each
rank's process (``python tests/torch_dist.py <task> <rank>``) joins a
process group through ``vdnerf_tpu_torch.parallel.world_from_env`` (gloo on the CPU,
NCCL for ``device="cuda:0"``; the card tests' ``backend="gloo"`` makes gloo
the group on the card, where two ranks may share one device), calls the
function with its ``World`` and writes the pickled result. This file imports
neither JAX nor a test module that does (the card functions take
``test_torch_cuda``'s small trainer), so that a rank starts in the time torch
and the port take to import.
"""

from __future__ import annotations

import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(fn: str, world_size: int = 2, timeout: float = 300.0, device: str = "cpu",
        backend: str | None = None, env: dict | None = None, **kwargs) -> list:
    """``fn(world, **kwargs)`` on every rank -> the ranks' results in rank
    order. Raises with a rank's output when one fails or the run times out."""
    with tempfile.TemporaryDirectory() as tmp:
        task = os.path.join(tmp, "task.pkl")
        with open(task, "wb") as f:
            pickle.dump((fn, device, backend, kwargs), f)
        port = _free_port()
        procs, logs = [], []
        for rank in range(world_size):
            child_env = {**os.environ, **(env or {}), "RANK": str(rank),
                         "WORLD_SIZE": str(world_size), "LOCAL_RANK": str(rank),
                         "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                         "OMP_NUM_THREADS": "1",
                         "PYTHONPATH": os.pathsep.join([ROOT, TESTS,
                                                        os.environ.get("PYTHONPATH", "")])}
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, __file__, task, str(rank)],
                                          env=child_env, stdout=log, stderr=subprocess.STDOUT))
        try:
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            log = logs[bad[0]]
            log.seek(0)
            tail = log.read()[-6000:]
            raise RuntimeError(f"{fn}: rank {bad[0]} of {world_size} exited with "
                               f"{procs[bad[0]].returncode}:\n{tail}")
        for log in logs:
            log.close()
        out = []
        for rank in range(world_size):
            with open(task + f".{rank}.out", "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def _model(nets, state: dict, device, mlp_dtype):
    from vdnerf_tpu_torch.ops.renderer import NeuSModel

    model = NeuSModel(nets, 0.3, torch.Generator().manual_seed(0), mlp_dtype=mlp_dtype)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.to(device)


def _cams(spec: dict, device):
    """A camera dict, or ``LearnedCameras`` from ``spec["learned"]``."""
    from vdnerf_tpu_torch.data.cameras import LearnedCameras

    if "learned" in spec:
        pose_all, focal, h, w, state = spec["learned"]
        cams = LearnedCameras(pose_all, focal, h, w)
        cams.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        return cams.to(device)
    return {k: torch.as_tensor(v, device=device) for k, v in spec.items()}


def step_cases(world, cases: list[dict], f32: bool = True, device: str = "cpu") -> list[dict]:
    """One training step's gradients per case, on this rank's block of the
    case's batch -> {metrics, grads, cam_grads, launches} per case. A case:
    the port's ``nets``, a ``state`` dict of numpy arrays, the ``tcfg``, the
    ``cams`` spec, the full ``batch`` and the ``step``. ``f32``: the fused
    MLPs' operands in f32 (the plain versions, as the CPU parity tests run
    them), else in bf16."""
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.parallel import shard_batch
    from vdnerf_tpu_torch.train.step import Trainer

    out = []
    for case in cases:
        model = _model(case["nets"], case["state"], device,
                       torch.float32 if f32 else torch.bfloat16)
        cams = _cams(case["cams"], device)
        tcfg = case["tcfg"]
        build.reset_launches()
        trainer = Trainer(tcfg, model, cams, None, world)
        block = shard_batch(case["batch"], world, tcfg.grad_accum)
        metrics = trainer.gradients(case["nets"], block, case["step"])
        rec = {"metrics": {k: float(v) for k, v in metrics.items()},
               "grads": {n: p.grad.cpu().numpy() for n, p in model.named_parameters()},
               "rays": int(block["pixels_x"].shape[0]), "launches": dict(build.LAUNCHES)}
        if trainer.learnable:
            rec["cam_grads"] = {n: p.grad.cpu().numpy() for n, p in cams.named_parameters()}
        out.append(rec)
    return out


def collectives(world, seed: int = 0) -> dict:
    """The parallel module's pieces on their own: ``World.sum``'s value and
    gradient, ``all_reduce_grads``, and the rank's jitter stream."""
    from vdnerf_tpu_torch import parallel

    x = torch.tensor(float(world.rank + 1), requires_grad=True)
    y = world.sum(3.0 * x)
    y.backward()
    p = torch.nn.Parameter(torch.zeros(2, 3))
    q = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.full((2, 3), float(world.rank + 1))
    q.grad = torch.arange(4.0) * (world.rank + 1)
    parallel.all_reduce_grads([p, q])
    gen = torch.Generator().manual_seed(parallel.rank_seed(seed, world.rank))
    return {"sum": float(y), "sum_grad": float(x.grad), "p_grad": p.grad.numpy(),
            "q_grad": q.grad.numpy(),
            "jitter": torch.rand(8, generator=gen).numpy(),
            "any": world.any(world.rank == world.size - 1),
            "object": world.broadcast_object({"rank": world.rank})}


def several(world, calls: list[tuple[str, dict]]) -> list:
    """Each ``(function name, keyword arguments)`` of ``calls`` in turn, in
    one group -> their results."""
    return [globals()[fn](world, **kwargs) for fn, kwargs in calls]


def _count_io(counts: dict):
    """Wrap the runner's writers so that each counts its calls on this rank."""
    from vdnerf_tpu_torch import runner as runner_mod
    from vdnerf_tpu_torch.io import logging as io_logging

    def counted(cls, name):
        fn = getattr(cls, name)

        def wrapper(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)

        setattr(cls, name, wrapper)

    for name in ("save_checkpoint", "validate_image", "validate_mesh", "val_all_imgs"):
        counted(runner_mod.Runner, name)
    counted(io_logging.MetricsWriter, "write")
    counted(runner_mod, "record_run")


def train_runs(world, conf: str, sigterm_conf: str, case: str = "CASE_NAME",
               mesh_res: int = 16) -> dict:
    """``Runner.train`` of ``conf`` with the writers counted, then of
    ``sigterm_conf`` with a SIGTERM delivered to the last rank's handler
    during its first window -> {run: {summary, counts, iter_step, seed}}."""
    from vdnerf_tpu_torch import runner as runner_mod
    from vdnerf_tpu_torch.train.dispatch import StepDispatch

    full = runner_mod.mesh_resolution
    runner_mod.mesh_resolution = lambda step: (mesh_res, full(step)[1])
    counts: dict = {}
    _count_io(counts)
    out = {}
    runner = runner_mod.Runner(conf, case, device="cpu", mode="train", world=world)
    summary = runner.train()
    out["run"] = {"summary": summary, "counts": dict(counts), "iter_step": runner.iter_step,
                  "seed": runner.trainer.generator.initial_seed()}

    counts.clear()
    if world.rank == world.size - 1:
        run = StepDispatch.run

        def run_then_signal(self, steps, nets, batches):
            window = run(self, steps, nets, batches)
            if steps[0] == 0:  # SIGTERM arrives during the first window
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            return window

        StepDispatch.run = run_then_signal
    runner = runner_mod.Runner(sigterm_conf, case, device="cpu", mode="train", world=world)
    summary = runner.train()
    out["sigterm"] = {"summary": summary, "counts": dict(counts),
                      "iter_step": runner.iter_step}
    return out


def card_dispatch(world, perturb: float | None = None) -> dict:
    """The card tests' 12 steps of ``test_torch_cuda._small_trainer`` (which
    imports no JAX) through ``StepDispatch`` in windows of 4, each step on
    this rank's block of its batch, on ``cuda:<LOCAL_RANK>``, with the
    renderer's ``perturb`` replaced when given -> every step's metrics, the
    final parameters, the launches, the captured programs."""
    import dataclasses

    from test_torch_cuda import _small_trainer
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.parallel import shard_batch
    from vdnerf_tpu_torch.train.dispatch import StepDispatch

    trainer, faithful, resampled, batches = _small_trainer(
        torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    trainer.world = world
    if perturb is not None:
        faithful, resampled = (dataclasses.replace(n, renderer=dataclasses.replace(
            n.renderer, perturb=perturb)) for n in (faithful, resampled))
    batches = [shard_batch(b, world) for b in batches]
    cores = [faithful if s < 8 else resampled for s in range(12)]
    dispatch = StepDispatch(trainer)
    build.reset_launches()
    metrics = []
    for w in range(3):
        steps = range(4 * w, 4 * w + 4)
        metrics += dispatch.run(steps, cores[4 * w:4 * w + 4], batches[4 * w:4 * w + 4]).read()
    return {"metrics": metrics, "launches": dict(build.LAUNCHES),
            "programs": len(dispatch.programs),
            "params": {n: p.detach().cpu().numpy() for n, p in trainer.model.named_parameters()}}


def card_step(world) -> dict:
    """One eager step of ``test_torch_cuda._small_trainer`` at step 6 (the
    depth head distills), perturb 0, on this rank's block of its 256-ray
    batch, on cuda:0 (the gloo ranks share the card) -> loss, summed
    gradients, launches."""
    import dataclasses

    from test_torch_cuda import _small_trainer
    from vdnerf_tpu_torch.ops.kernels import build
    from vdnerf_tpu_torch.parallel import shard_batch

    trainer, faithful, _, batches = _small_trainer(torch.device("cuda:0"))
    nets = dataclasses.replace(faithful,
                               renderer=dataclasses.replace(faithful.renderer, perturb=0.0))
    trainer.generator = None
    trainer.world = world
    build.reset_launches()
    metrics = trainer.gradients(nets, shard_batch(batches[6], world), 6)
    return {"loss": float(metrics["loss"]), "launches": dict(build.LAUNCHES),
            "grads": {n: p.grad.cpu().numpy() for n, p in trainer.model.named_parameters()}}


def _main(task: str, rank: int) -> None:
    torch.set_num_threads(1)
    from vdnerf_tpu_torch import parallel

    with open(task, "rb") as f:
        fn, device, backend, kwargs = pickle.load(f)
    if backend is not None:
        torch.distributed.init_process_group(backend, rank=rank,
                                             world_size=int(os.environ["WORLD_SIZE"]))
    with parallel.world_from_env(torch.device(device)) as world:
        if world.rank != rank:
            raise RuntimeError(f"rank {world.rank} started as {rank}")
        result = globals()[fn](world, **kwargs)
    with open(task + f".{rank}.out", "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))
