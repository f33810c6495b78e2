"""The sample mesh: the K candidate rollouts of a control step spread over
the ranks of a `torch.distributed` process group.

Counterpart of `mpopis_tpu/parallel/mesh.py`. The reference's only
parallelism is Julia threads over the K rollouts; the scaling dimension here
is the same K axis, one rank per card: each rank rolls out its own
contiguous block of samples through the env's rollout kernel, while the
small distribution-update math stays replicated on every rank. Cross-rank
reductions ride `torch.distributed.all_reduce` (`parallel.collectives`).

JAX's `sample_sharding` and `replicated` (NamedShardings over a device mesh)
have no torch meaning: a rank holds whole tensors, and `SampleMesh.block`
says which columns of the (cs, K) sample matrix are its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class SampleMesh:
    """One rank's view of the sample mesh: its process group, its rank in
    it, the number of ranks and the device its tensors live on."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    world_size: int
    device: torch.device

    def block(self, k: int) -> tuple[int, int]:
        """(start, stop) of this rank's contiguous block of the K samples.
        The blocks hold ⌈K/n⌉ or ⌊K/n⌋ samples, the larger ones first, so K
        need not divide by the number of ranks."""
        base, extra = divmod(k, self.world_size)
        start = self.rank * base + min(self.rank, extra)
        return start, start + base + (self.rank < extra)


def distributed_init(backend: str | None = None, **kwargs) -> None:
    """Join the process group: `torch.distributed.init_process_group`, or
    nothing when this process already holds one.

    `backend` defaults to `nccl` where a CUDA card is visible and `gloo`
    otherwise; `kwargs` go to `init_process_group` (`init_method`,
    `world_size`, `rank`; without them the launcher's environment
    variables, as `torch.distributed.run` sets them). `timeout` defaults to
    DEFAULT_TIMEOUT, so that a rank that died fails the others' collectives
    rather than hanging them.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs.setdefault("timeout", DEFAULT_TIMEOUT)
    dist.init_process_group(backend, **kwargs)


def make_sample_mesh(device=None) -> SampleMesh:
    """The sample mesh over every rank of the process group; every rank
    calls it. The number of ranks is the number of processes started.

    `device` defaults to `cuda:LOCAL_RANK`, and raises without a card: the
    mesh never moves to the CPU by itself. Pass `device="cpu"` for a CPU
    mesh (gloo), or an explicit card, which several gloo ranks may share.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed_init() first")
    group = dist.group.WORLD
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the sample mesh's default device is a CUDA card, and none is "
                               "visible; pass device='cpu' for a CPU mesh")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif dist.get_backend(group) == "nccl":
        raise ValueError(f"an nccl process group cannot reduce tensors on {device}")
    return SampleMesh(group=group, rank=dist.get_rank(), world_size=dist.get_world_size(),
                      device=device)


def spawn_ranks(fn, nprocs: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run `fn(rank, *args)` in `nprocs` new processes (the `spawn` start
    method: `fn` and `args` are pickled, so `fn` lives at module level in a
    module that the children can import) and wait for all of them.

    A rank that raises or exits non-zero fails the run: the others are
    stopped and the error is raised here. So is a run still going after
    `timeout` seconds. No process outlives the call.
    """
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after {timeout:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
