"""Multi-process start-up and the collectives the sharded paths use.

The port of the JAX package's ``parallel/distributed.py``.
``initialize_distributed`` starts ``torch.distributed`` from explicit
arguments or from torchrun's environment (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and returns False when neither
names a process group. The backend is NCCL when every process of this
host has a card of its own, else gloo; gloo moves host tensors only, so
the collectives below stage CUDA tensors through the host there. An init
that was asked for and fails raises (the JAX function logs a warning and
goes on in one process, which would hide the mesh).

``global_mesh`` is the mesh over every process's devices, in (rank, local
device) order. ``all_gather_cat_grad`` is the gather with the gradient
flowing back through it, and ``all_reduce_sum`` sums a list of tensors
over the processes: the data-parallel AE trainer's two collectives.
"""

from __future__ import annotations

import logging
import os

import torch

from .mesh import DATA_AXIS, Mesh, make_mesh

log = logging.getLogger("latentrag_torch.parallel")


def _pick_backend(world: int) -> str:
    """NCCL when every process on this host can hold a card of its own
    (torchrun's ``LOCAL_WORLD_SIZE``, else all ``world`` on one host),
    else gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float | None = None,
) -> bool:
    """Start the default process group; True when more than one process
    takes part. ``coordinator_address`` is ``host:port`` (or
    ``tcp://host:port``); without it torchrun's environment is read, and
    with neither this is a no-op returning False. ``backend`` overrides
    the choice of NCCL or gloo; ``timeout`` (seconds) bounds the
    rendezvous and every collective (PyTorch's default without it). A
    failed start raises RuntimeError."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    backend = backend or _pick_backend(num_processes)
    try:
        if backend == "nccl":
            local_rank = int(env.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        extra = {}
        if timeout is not None:
            import datetime

            extra["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(backend, init_method=addr,
                                world_size=num_processes, rank=process_id,
                                **extra)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend!r}, {addr}, "
            f"world_size={num_processes}, rank={process_id}) failed: {e}"
        ) from e
    log.info("distributed runtime: process %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def global_mesh(devices=None, axis: str = DATA_AXIS) -> Mesh:
    """A mesh over every process's devices: this process's ``devices``
    (default: its own card, ``LOCAL_RANK`` or the rank modulo the cards,
    or the CPU without CUDA) after those of the lower ranks. Every process
    must pass as many devices."""
    if devices is None:
        if torch.cuda.is_available():
            import torch.distributed as dist

            rank = dist.get_rank() if dist.is_initialized() else 0
            local = int(os.environ.get("LOCAL_RANK", rank))
            devices = [f"cuda:{local % torch.cuda.device_count()}"]
        else:
            devices = ["cpu"]
    return make_mesh(devices=devices, axis=axis)


def collective_device(mesh: Mesh) -> torch.device:
    """Where a collective's tensors must live: this process's first card
    under NCCL, the host under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return next(d for d in mesh.devices if d.type == "cuda")
    return torch.device("cpu")


def all_gather_cat(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every process's ``x`` (same shape on each), concatenated along dim
    0 in rank order, on the collective's device."""
    import torch.distributed as dist

    t = x.to(collective_device(mesh)).contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(out, t)
    return torch.cat(out)


def barrier() -> None:
    """A barrier across the process group; a no-op without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class _AllGatherCatGrad(torch.autograd.Function):
    """``all_gather_cat`` whose backward sums every process's gradient of
    this process's rows (the transpose of a gather, JAX's
    ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows, ctx.device = mesh, x.shape[0], x.device
        return all_gather_cat(x, mesh).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        g = grad.to(collective_device(ctx.mesh)).contiguous()
        dist.all_reduce(g)
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows].to(ctx.device), None


def all_gather_cat_grad(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_gather_cat`` on ``x``'s device, with the gradient flowing back
    through the gather: each process's rows receive the sum over every
    process of the gradient at their place in the result (gloo stages
    through the host, as the other collectives do). Without a process
    group it returns ``x``."""
    if mesh.world == 1:
        return x
    return _AllGatherCatGrad.apply(x, mesh)


def all_reduce_sum(tensors: list, mesh: Mesh) -> list:
    """Every tensor summed over the mesh's processes (one ``all_reduce`` of
    their flattened concatenation), back on each tensor's device."""
    import torch.distributed as dist

    if mesh.world == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(collective_device(mesh))
                      for t in tensors])
    dist.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.device))
        at += t.numel()
    return out
