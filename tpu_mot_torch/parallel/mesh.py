"""Device meshes over torch.distributed for multi-stream serving and
detector training (counterpart of tpu_mot/parallel/mesh.py).

The JAX package's two parallel axes carry over:

  * "stream": independent video streams; each rank owns the TrackBanks of
    a contiguous block of streams (serving, BASELINE.json configs[4]).
  * "batch": data parallelism of detector training (the gradient sum).

A mesh is a 1-D `torch.distributed.device_mesh.DeviceMesh` over every rank
of the default process group, one process per rank (`torchrun`, or
`spawn` below).  Its group carries the collectives: NCCL between cards,
gloo on the CPU.  gloo may also be asked for explicitly on CUDA, which is
how several ranks share one card (NCCL takes one rank per card).

Where JAX lays one global array over its devices (NamedSharding), a rank
here holds its block of it: `shard_leading` gives rank r the rows
[r*k, (r+1)*k) of the leading dimension, as P(axis) splits a global
array, and `replicated` gives every rank rank 0's value, as P() does.

Under gloo every collective of this module runs on host copies: a CUDA
tensor is copied to the CPU, reduced, gathered or broadcast there, and
copied back (so the mesh's device type is "cpu").  This keeps the
several-ranks-on-one-card run independent of which collectives a torch
build's gloo accepts for CUDA tensors.  Under NCCL a CPU tensor (Adam's
step count) is staged through the rank's card the same way.
"""

from __future__ import annotations

import os
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu_mot_torch.tracker.bank import resolve_device

# A hung collective fails after this long instead of eating a caller's
# clock (tests, the chip run).
DEFAULT_TIMEOUT = timedelta(seconds=300)


def default_backend(device: torch.device) -> str:
    """NCCL on a card, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def local_device(device=None) -> torch.device:
    """`device`, or `cuda:{LOCAL_RANK}` (0 when the variable is unset) when
    it is None or "cuda" without an index.  Raises when it names a card
    that is not there (bank.resolve_device); never falls back to the
    CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} asked for, but this machine shows "
                           f"{torch.cuda.device_count()} CUDA card(s)")
    return dev


def _mesh(dim: str, n, device, backend) -> DeviceMesh:
    dev = local_device(device)
    backend = backend or default_backend(dev)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs between cards; {dev} needs gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        # from the environment: torchrun's RANK, WORLD_SIZE, MASTER_ADDR
        dist.init_process_group(backend, timeout=DEFAULT_TIMEOUT)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}; "
                         f"{backend} was asked for")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks asked for in a process "
                         f"group of {world}: the mesh spans every rank")
    return init_device_mesh("cuda" if backend == "nccl" else "cpu",
                            (world,), mesh_dim_names=(dim,))


def stream_mesh(n: int | None = None, device=None,
                backend: str | None = None) -> DeviceMesh:
    """1-D mesh over the "stream" axis (serving) on every rank of the
    default process group, which it initialises from the environment
    (torchrun) if it is not up.  n, when given, must be the world size.
    device: this rank's device (default `cuda:{LOCAL_RANK}`); backend:
    default NCCL on a card, gloo on the CPU; "gloo" on a card is allowed
    (several ranks on one card)."""
    return _mesh("stream", n, device, backend)


def batch_mesh(n: int | None = None, device=None,
               backend: str | None = None) -> DeviceMesh:
    """1-D mesh over the "batch" axis (detector training); as
    stream_mesh."""
    return _mesh("batch", n, device, backend)


def shard_leading(x: torch.Tensor, mesh: DeviceMesh,
                  axis: str | None = None) -> torch.Tensor:
    """This rank's contiguous block of x's leading dimension: rank r of n
    holds rows [r*k, (r+1)*k), k = len(x) / n (the block of a global array
    that P(axis) puts on device r).  axis names the mesh's axis (default
    its one axis).  Raises when n does not divide len(x)."""
    r, n = mesh.get_local_rank(axis), mesh.size()
    if x.shape[0] % n:
        raise ValueError(f"leading dimension {x.shape[0]} does not split "
                         f"over {n} ranks")
    k = x.shape[0] // n
    return x[r * k:(r + 1) * k]


def _comm_device(mesh: DeviceMesh) -> torch.device:
    """Where the mesh's collectives take their tensors: the CPU under gloo,
    this rank's card under NCCL."""
    if dist.get_backend(mesh.get_group()) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def all_gather_leading(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's x concatenated on the leading dimension in rank order
    (jax.lax.all_gather(..., tiled=True)); every rank's x has one shape."""
    g, dev = mesh.get_group(), _comm_device(mesh)
    xs = x.to(dev).contiguous()
    parts = [torch.empty_like(xs) for _ in range(mesh.size())]
    dist.all_gather(parts, xs, group=g)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh,
                   grad: bool = False) -> torch.Tensor:
    """The sum of every rank's x, a new tensor.  grad=True makes it
    differentiable: the backward pass sums the gradients arriving at every
    rank's result, which is the gradient of a sum of per-rank losses with
    respect to this rank's x (torch.distributed.nn's all_reduce, which
    newer torch deprecates)."""
    if grad:
        return _AllReduceSum.apply(x, mesh)
    xs = x.detach().to(_comm_device(mesh), copy=True)
    dist.all_reduce(xs, group=mesh.get_group())
    return xs.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.mesh), None


def broadcast_(x: torch.Tensor, mesh: DeviceMesh) -> None:
    """Overwrite x in place with the x of the mesh's rank 0."""
    g, dev = mesh.get_group(), _comm_device(mesh)
    xs = x.detach().to(dev, copy=True).contiguous()
    dist.broadcast(xs, src=dist.get_global_rank(g, 0), group=g)
    with torch.no_grad():
        x.copy_(xs)


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Rank 0's x on every rank (a copy; x keeps this rank's value)."""
    out = x.clone()
    broadcast_(out, mesh)
    return out


def _rank_main(rank: int, fn, world: int, args: tuple, device: str,
               backend: str, store_dir: str) -> None:
    """One rank of spawn: torchrun's environment, this rank's device, the
    process group from a file store, fn, its return value to a file (its
    traceback, if it raises, written before the group comes down)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    dev = torch.device(device)
    if dev.type == "cpu":
        # ranks share the host's cores; one thread each also keeps the
        # CPU's convolutions bit-reproducible from run to run
        torch.set_num_threads(1)
    else:
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                            rank=rank, world_size=world,
                            timeout=DEFAULT_TIMEOUT)
    try:
        out = fn(rank, world, *args)
        path = os.path.join(store_dir, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(store_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device, backend: str | None = None) -> list:
    """Run fn(rank, world, *args) in `world` fresh processes joined in one
    process group; returns their return values in rank order (saved with
    torch.save: return CPU tensors).

    The processes start by the `spawn` method (fork breaks CUDA), so fn
    and args must pickle by import path, and fn's module must import
    neither JAX nor anything that starts work.  The group comes up through
    a file store in a fresh temporary directory (no fixed TCP port: many
    spawns may run at once) with DEFAULT_TIMEOUT on every collective.
    Each rank gets torchrun's RANK, LOCAL_RANK and WORLD_SIZE.  device:
    "cpu" (gloo ranks, one thread each), "cuda" (rank r on card r % count)
    or "cuda:i" (every rank on card i; needs backend="gloo" when world >
    1).  A failure in any rank stops the others and raises here, with the
    traceback of every rank that failed (the rank at fault first closes
    its group, so its peers then fail in their collectives)."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs between cards; {dev} needs gloo")
        n_cards = 1 if dev.index is not None else torch.cuda.device_count()
        if world > n_cards:
            raise ValueError(f"NCCL takes one rank per card: {world} ranks "
                             f"on {n_cards} card(s); pass backend='gloo' to "
                             "put several ranks on one card")
    with tempfile.TemporaryDirectory(prefix="tpu_mot_torch_spawn_") as tmp:
        try:
            mp.start_processes(_rank_main, args=(fn, world, args, str(dev),
                                                 backend, tmp),
                               nprocs=world, join=True, start_method="spawn")
        except Exception as e:
            errs = []
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"-- rank {r} of {world}:\n{f.read()}")
            raise RuntimeError("spawn: rank(s) failed\n"
                               + "".join(errs)) from e
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
