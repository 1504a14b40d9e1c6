"""Process groups and sharding helpers (``torch.distributed``).

Counterpart of ``dj_brdf_tpu/parallel/mesh.py``. The JAX package's mesh
is one process over n devices, and XLA inserts the collectives from
shardings. The port takes PyTorch's idiom: one process per device, a
``torch.distributed`` process group, NCCL on CUDA devices and gloo on
the CPU.

The ``mesh=`` contract of every entry point is JAX's:

* every rank calls the entry point with the same global inputs;
* each rank computes its own block of the sharded axis (materials,
  directions, kernel columns, pixels);
* collectives return to every rank the result of the unsharded call.

Start N ranks with ``torchrun --nproc-per-node N`` (then
:func:`make_mesh` finds the initialised world), or call
:func:`make_mesh` with no group initialised for a world of one started
in-process.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import warnings

import torch
import torch.distributed as dist

from dj_brdf_torch.core.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this rank of a process group and its device."""

    rank: int
    size: int
    device: torch.device

    # -- blocks ------------------------------------------------------
    def padded(self, n: int) -> int:
        """``n`` rounded up to a multiple of the world size (JAX's
        ``n_pad``)."""
        return -(-n // self.size) * self.size

    def block(self, n: int) -> slice:
        """This rank's block of an axis of ``n`` padded to
        :meth:`padded`: ``padded(n) / size`` entries, the last rank's
        partly (or wholly) padding."""
        per = self.padded(n) // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x, dim: int = 0, pad: str = "wrap"):
        """This rank's block of ``x`` along ``dim``, padded as
        :func:`pad_to` pads: ``"wrap"`` repeats leading entries (the JAX
        package's ``tables[arange(pad) % m]``), ``"zero"`` appends zeros
        (its padded kernel columns)."""
        x = pad_to(x, self.padded(x.shape[dim]), dim, pad)
        return x.narrow(dim, self.block(x.shape[dim]).start,
                        x.shape[dim] // self.size)

    def split(self, n: int) -> slice:
        """This rank's contiguous slice of ``range(n)`` without padding
        (blocks that only feed a sum): ``ceil(n / size)`` entries, fewer
        on the last ranks."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return slice(lo, min(lo + per, n))

    # -- collectives ---------------------------------------------------
    def all_gather(self, x, dim: int = 0, n: int | None = None):
        """Every rank's block of ``x`` (equal shapes) concatenated along
        ``dim`` in rank order, cut to ``n`` entries. Differentiable where
        ``x`` requires grad (``torch.distributed.nn``: its backward sums
        every rank's gradient of each block)."""
        x = x.contiguous()
        if x.requires_grad and torch.is_grad_enabled():
            from torch.distributed.nn.functional import all_gather
            with warnings.catch_warnings():
                # newer PyTorch marks it deprecated for a private module;
                # it still carries the gradient as documented
                warnings.simplefilter("ignore", FutureWarning)
                parts = all_gather(x)
        else:
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x)
        out = torch.cat(parts, dim)
        return out if n is None else out.narrow(dim, 0, n)

    def all_reduce_sum(self, x):
        """The sum over ranks of ``x``, on every rank (a new tensor)."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def all_reduce_mean(self, x):
        """The mean over ranks of ``x``, on every rank."""
        return self.all_reduce_sum(x) / self.size

    def replicated(self, tree):
        """``tree`` (a tensor or a dataclass pytree) whose tensors that
        require grad pass through an identity with an all-reduce-mean
        backward: a replicated input. Behind a differentiable
        :meth:`all_gather` (whose backward sums the ranks' gradients of
        each block) every rank then gets the gradient of the mean of the
        ranks' losses, the unsharded gradient when they agree, as XLA's
        psum of replicated parameters' gradients gives."""
        def entry(t):
            if t.requires_grad and torch.is_grad_enabled():
                return _ReplicatedGrad.apply(t, self)
            return t
        return tree_map(entry, tree)


class _ReplicatedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_mean(grad.contiguous()), None


def pad_to(x, n_pad: int, dim: int = 0, pad: str = "wrap"):
    """``x`` grown along ``dim`` to ``n_pad`` entries: ``"wrap"`` appends
    copies of its leading entries, ``"zero"`` zeros."""
    n = x.shape[dim]
    if n_pad == n:
        return x
    if pad == "zero":
        shape = list(x.shape)
        shape[dim] = n_pad - n
        return torch.cat([x, x.new_zeros(shape)], dim)
    if pad != "wrap":
        raise ValueError(f"pad must be 'wrap' or 'zero', got {pad!r}")
    idx = torch.arange(n_pad - n, device=x.device) % n
    return torch.cat([x, x.index_select(dim, idx)], dim)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda", init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> Mesh:
    """Initialise the default process group and return its :class:`Mesh`.
    Arguments left None come from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, read
    through ``env://``). The backend is NCCL for a CUDA ``device``, whose
    index becomes ``LOCAL_RANK`` (default 0), and gloo for the CPU."""
    device = torch.device(device)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        init_method = "env://"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(_backend(device), init_method=init_method,
                            world_size=world_size, rank=rank)
    return Mesh(rank=rank, size=world_size, device=device)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of the initialised world (initialised here from
    torchrun's environment where torchrun started the process), or, when
    there is none, a world of one started in-process on ``device`` (the
    card unless the caller asks for ``"cpu"``). ``n_devices`` must be the
    world's size: a world of N ranks comes from ``torchrun
    --nproc-per-node N``. An initialised group of another backend than
    ``device`` takes (NCCL for CUDA, gloo for the CPU) raises."""
    if not dist.is_initialized() and "MASTER_ADDR" in os.environ:
        init_distributed(device)                 # started by torchrun
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} devices needs {n_devices} processes: "
                f"start them with torchrun --nproc-per-node {n_devices} (no "
                "process group is initialised, so only a world of 1 runs "
                "in-process)")
        return init_distributed(device, f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"a mesh of {n_devices} devices, but the process group has "
            f"{size} ranks: start {n_devices} processes with torchrun "
            f"--nproc-per-node {n_devices}")
    backend = dist.get_backend()
    if backend != _backend(torch.device(device)):
        raise ValueError(
            f"a mesh on {device!r} needs a {_backend(torch.device(device))} "
            f"process group, but the initialised one is {backend}: destroy "
            "it (torch.distributed.destroy_process_group) or ask for its "
            "device")
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return Mesh(rank=dist.get_rank(), size=size, device=dev)
