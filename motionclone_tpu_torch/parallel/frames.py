"""Frame sharding over ``torch.distributed``: one video's frame axis split
over the ranks of a process group.

Port of the ``frames`` axis of ``motionclone_tpu/parallel/mesh.py``
(``make_mesh_video``, ``frame_sharding``, ``shard_params``) and of the
``frame_shard_map`` wiring of ``motionclone_tpu/pipeline/motionclone.py``:

* every rank holds the same parameters, built from the same seed or carried
  from the same flax tree (``weights/from_jax.py``), and frames
  [rank * f, (rank + 1) * f) of every (B, F, H, W, C) video tensor;
* resnets, GroupNorms (per frame: sharding needs ``use_inflated_groupnorm``)
  and spatial attention work per frame, on the local frames;
* a motion module gathers its keys and values over the group
  (:meth:`FrameGroup.all_gather`, tiled in rank order) and attends with its
  local queries: the rectangular temporal kernels 3r and 4r;
* the gather's backward is its transpose: the full cotangent summed over the
  ranks (``all_reduce``), then the rank's own frames.  Each rank
  differentiates its own partial guidance loss, and the terms that cross
  ranks arrive through that sum.

Every rank must issue the same collectives in the same order.  The routing
depends only on shapes, which the ranks share, and autograd runs the
gathers' backwards in the same order on every rank.  Each collective fails
after the group's timeout instead of hanging.

Backends: ``nccl`` where each rank has its own GPU (:meth:`FrameGroup.from_env`
under ``torchrun``); ``gloo`` where ranks share one card or run on the CPU
(:func:`launch`).  Under gloo every collective stages its tensor through
host memory.  The caller names the backend; nothing switches it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 600.0
_FAILURE_GRACE_S = 10.0


@dataclasses.dataclass(frozen=True)
class FrameGroup:
    """The ranks of the default process group, which share one video's
    frames."""

    rank: int
    size: int
    backend: str

    @classmethod
    def from_env(cls, backend: str = "nccl",
                 timeout: float = DEFAULT_TIMEOUT_S) -> "FrameGroup":
        """Join the default process group from torchrun's variables (RANK,
        WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the GPU under
        nccl).  Collectives fail after ``timeout`` seconds."""
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=size, timeout=timedelta(seconds=timeout))
        return cls(rank, size, backend)

    def local_frames(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The rank's contiguous share of axis ``dim`` (a view)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"{n} frames do not split over {self.size} ranks")
        f = n // self.size
        return x.narrow(dim, self.rank * f, f)

    def gather_frames(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order, without
        grad: latents, or a motion representation's query-frame axis (3 of
        (B, S, heads, F, 1))."""
        with torch.no_grad():
            return self._all_gather(x, dim)

    def all_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """:meth:`gather_frames` under autograd: the backward sums the
        cotangent over the ranks and returns the rank's own frames."""
        return _GatherFrames.apply(x, self, dim)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, as a new tensor of x's dtype
        (summed in float32 where x has fewer bits)."""
        acc = torch.promote_types(x.dtype, torch.float32)
        buf = x.detach().to(device=self._comm_device(x), dtype=acc, copy=True,
                            memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return buf.to(device=x.device, dtype=x.dtype)

    def _comm_device(self, x: torch.Tensor) -> torch.device:
        # gloo stages tensors through host memory; nccl works on the device
        return torch.device("cpu") if self.backend == "gloo" else x.device

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        buf = x.detach().to(device=self._comm_device(x),
                            memory_format=torch.contiguous_format)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        return torch.cat(parts, dim=dim).to(x.device)


class _GatherFrames(torch.autograd.Function):
    """Tiled all_gather on one axis; its VJP is the transpose (sum over the
    ranks, then the rank's slice), the role of JAX's all_gather transpose."""

    @staticmethod
    def forward(ctx, x, group: FrameGroup, dim: int):
        ctx.group, ctx.dim = group, dim
        return group._all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        total = ctx.group.all_reduce_sum(grad)
        return ctx.group.local_frames(total, ctx.dim).contiguous(), None, None


# ---------------------------------------------------------------------------
# launcher: N ranks in new processes, on given devices
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, size: int, backend: str, device: Optional[str],
               args: tuple, timeout: float, workdir: str) -> None:
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
            rank=rank, world_size=size, timeout=timedelta(seconds=timeout),
        )
        try:
            out = fn(FrameGroup(rank, size, backend), *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        sys.exit(1)


def launch(fn: Callable[..., Any], nprocs: int, *, backend: str,
           devices: Optional[Sequence[str]] = None, args: Sequence = (),
           timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(FrameGroup, *args)`` on ``nprocs`` new processes, one rank
    each, and return what each returned, in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    something ``torch.save`` can write.  ``devices[r]`` is rank r's device
    ("cuda:0", ...; several ranks may name one card, which needs
    ``backend="gloo"``), or None for the CPU.  The ranks meet through a
    ``file://`` rendezvous in a new temporary directory, so launches made at
    once never collide on a port.  Raises, with the rank's traceback, as
    soon as a rank fails, and raises if the ranks have not all finished
    within ``timeout`` seconds (also each collective's limit); no rank is
    left running either way.  After a failure the other ranks get a few
    seconds to fail or finish on their own, so that the report holds every
    rank's traceback."""
    if devices is not None and len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="frame_group_") as workdir:
        procs = [
            ctx.Process(target=_rank_main, args=(
                fn, r, nprocs, backend, None if devices is None else devices[r],
                tuple(args), timeout, workdir))
            for r in range(nprocs)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    # the other ranks soon fail too (their peer is gone) or
                    # finish: give them a moment, so that the report holds
                    # every traceback, the cause's among them
                    grace = time.monotonic() + _FAILURE_GRACE_S
                    for p in procs:
                        p.join(max(0.0, grace - time.monotonic()))
                    codes = [p.exitcode for p in procs]
                    failed = [r for r, c in enumerate(codes) if c != 0]
                    raise RuntimeError(_failure_report(workdir, failed, codes))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {[r for r, c in enumerate(codes) if c is None]} of "
                        f"{nprocs} still running after {timeout:.0f} s"
                    )
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [
            torch.load(os.path.join(workdir, f"result_{r}.pt"), map_location="cpu",
                       weights_only=False)
            for r in range(nprocs)
        ]


def _failure_report(workdir: str, failed: List[int], codes: List[Optional[int]]) -> str:
    lines = [f"frame group ranks {failed} failed (exit codes {codes}; None: "
             f"still running, then killed)"]
    for r in failed:
        path = os.path.join(workdir, f"error_{r}.txt")
        if os.path.exists(path):
            with open(path) as fh:
                lines.append(f"--- rank {r}:\n{fh.read()}")
    return "\n".join(lines)
