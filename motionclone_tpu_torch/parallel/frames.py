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

:class:`Layout` is the port of ``make_mesh_video`` (cfg, frames),
``make_mesh_sweep`` (data, cfg, frames) and ``make_mesh_2d`` (data, cfg):
the world's ranks ordered as those meshes order their devices, rank =
(d * cfg + c) * frames + f, so the frame shards of one video are adjacent
ranks.  Each rank holds its frame group (the ``frames`` ranks of its video
and CFG half), its CFG pair (the rank of the other half at the same
frames; group rank 0 is the unconditional half) and its video group (the
cfg * frames ranks of its data index).  Data groups share nothing: no
collective crosses them.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 600.0
_FAILURE_GRACE_S = 10.0


@dataclasses.dataclass(frozen=True, eq=False)
class FrameGroup:
    """A group of ranks: one video's frame shards, or a CFG pair, or a
    video's ranks.  ``rank`` is this process's place in the group
    (``dist.get_rank(group)``, not the global rank), ``group`` the
    ``torch.distributed`` process group (None: the default group) and
    ``ranks`` its members' global ranks in group order (None: 0 .. size-1).
    Every collective runs in ``group``."""

    rank: int
    size: int
    backend: str
    group: Optional[Any] = None
    ranks: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_env(cls, backend: str = "nccl",
                 timeout: float = DEFAULT_TIMEOUT_S) -> "FrameGroup":
        """Join the default process group from torchrun's variables (RANK,
        WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the GPU under
        nccl).  Collectives fail after ``timeout`` seconds."""
        rank, size = _init_from_env(backend, timeout)
        return cls(rank, size, backend)

    def global_rank(self, index: int) -> int:
        """The global rank of the group's member ``index``."""
        return index if self.ranks is None else self.ranks[index]

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
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(device=x.device, dtype=x.dtype)

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Member ``src``'s ``obj`` (picklable) on every rank of the group."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=self.global_rank(src), group=self.group)
        return box[0]

    def barrier(self) -> None:
        """Wait until every rank of the group arrives (a one-element gather
        in the group, on the card under nccl)."""
        dev = torch.device("cuda", torch.cuda.current_device()) if self.backend == "nccl" \
            else torch.device("cpu")
        self.gather_frames(torch.zeros(1, 1, device=dev))

    def _comm_device(self, x: torch.Tensor) -> torch.device:
        # gloo stages tensors through host memory; nccl works on the device
        return torch.device("cpu") if self.backend == "gloo" else x.device

    def _all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        buf = x.detach().to(device=self._comm_device(x),
                            memory_format=torch.contiguous_format)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)


def exchange_pair(pair: FrameGroup, tensors: Sequence[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The CFG-pair combine: each of ``tensors`` (same shapes on both
    halves) as the unconditional half (pair rank 0) holds it and as the
    conditional half (pair rank 1) holds it, on both ranks.  JAX's
    ``only_uncond`` / ``only_cond`` masked psums over ``cfg``, as one
    all_gather of the tensors packed into one buffer (in their widest
    dtype, so that each arrives bit for bit)."""
    if pair.size != 2:
        raise ValueError(f"a CFG pair has 2 ranks, this group {pair.size}")
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    both = pair.gather_frames(flat[None], dim=0)
    halves = ([], [])
    for half, row in zip(halves, both):
        offset = 0
        for t in tensors:
            half.append(row[offset:offset + t.numel()].view(t.shape).to(t.dtype))
            offset += t.numel()
    return halves


def _init_from_env(backend: str, timeout: float) -> Tuple[int, int]:
    """Initialise the default process group from torchrun's variables;
    returns (rank, world size)."""
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=size, timeout=timedelta(seconds=timeout))
    return rank, size


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """This rank's place in a (data, cfg, frames) layout of the world:
    rank = (d * cfg + c) * frames + f.  ``frame_group``: the ``frames``
    ranks of this rank's video and CFG half (None when frames == 1);
    ``pair``: this rank and its other CFG half (None when cfg == 1; pair
    rank 0 runs the unconditional half, 1 the conditional); ``video``: the
    cfg * frames ranks of this rank's data index, whose rank 0 is the
    video's lead (it decides the caches, decodes and writes)."""

    data: int
    cfg: int
    frames: int
    rank: int
    backend: str
    frame_group: Optional[FrameGroup]
    pair: Optional[FrameGroup]
    video: FrameGroup
    owns_world: bool = False

    @property
    def data_index(self) -> int:
        return self.rank // (self.cfg * self.frames)

    @property
    def is_lead(self) -> bool:
        return self.video.rank == 0

    @classmethod
    def build(cls, data: int, cfg: int, frames: int, backend: str,
              timeout: float = DEFAULT_TIMEOUT_S, owns_world: bool = False) -> "Layout":
        """The layout over the initialised default group, whose size must be
        data * cfg * frames.  Every rank makes every subgroup, in the same
        order, also those it is not in (``dist.new_group`` is collective)."""
        if data < 1 or cfg not in (1, 2) or frames < 1 or cfg * frames < 2:
            raise ValueError(f"a layout of data={data}, cfg={cfg}, frames={frames}: cfg is "
                             f"1 or 2, and cfg * frames at least 2")
        size, rank = dist.get_world_size(), dist.get_rank()
        if size != data * cfg * frames:
            raise ValueError(f"a layout of data={data} x cfg={cfg} x frames={frames} "
                             f"needs {data * cfg * frames} ranks, the world has {size}")
        at = lambda d, c, f: (d * cfg + c) * frames + f
        pg_timeout = timedelta(seconds=timeout)

        def groups(members: List[List[int]]) -> Optional[FrameGroup]:
            mine = None
            for ranks in members:
                pg = dist.new_group(ranks, timeout=pg_timeout)
                if rank in ranks:
                    mine = FrameGroup(ranks.index(rank), len(ranks), backend, pg,
                                      tuple(ranks))
            return mine

        frame_group = groups([[at(d, c, f) for f in range(frames)]
                              for d in range(data) for c in range(cfg)]) if frames > 1 else None
        pair = groups([[at(d, c, f) for c in range(cfg)]
                       for d in range(data) for f in range(frames)]) if cfg > 1 else None
        video = groups([[at(d, c, f) for c in range(cfg) for f in range(frames)]
                        for d in range(data)])
        return cls(data, cfg, frames, rank, backend, frame_group, pair, video, owns_world)

    @classmethod
    def from_env(cls, frames: int, cfg: int = 1, backend: str = "nccl",
                 data: Optional[int] = None, timeout: float = DEFAULT_TIMEOUT_S) -> "Layout":
        """The layout of torchrun's world (WORLD_SIZE, RANK, LOCAL_RANK),
        joining the default process group unless it is initialised
        already.  ``data=None`` takes as many data groups as the world
        holds; a world of another size raises, naming the torchrun call."""
        per = cfg * frames
        world = int(os.environ.get("WORLD_SIZE", 1)) if not dist.is_initialized() \
            else dist.get_world_size()
        want = data * per if data is not None else None
        if (want is not None and world != want) or world % per:
            raise ValueError(
                f"a layout of cfg={cfg} x frames={frames} ranks per video needs a world of "
                f"{want if want is not None else f'a multiple of {per}'} ranks, this one has "
                f"{world}: run under torchrun --nproc-per-node {want or per}")
        owns = not dist.is_initialized()
        if owns:
            _init_from_env(backend, timeout)
        return cls.build(world // per, cfg, frames, backend, timeout, owns_world=owns)

    def close(self) -> None:
        """Destroy the default process group where this layout made it."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()


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
               args: tuple, timeout: float, workdir: str,
               layout: Optional[Tuple[int, int, int]]) -> None:
    try:
        # torchrun's variables, for code in the rank that reads them (the CLIs)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
            rank=rank, world_size=size, timeout=timedelta(seconds=timeout),
        )
        try:
            first = (FrameGroup(rank, size, backend) if layout is None
                     else Layout.build(*layout, backend=backend, timeout=timeout))
            out = fn(first, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        sys.exit(1)


def launch(fn: Callable[..., Any], nprocs: int, *, backend: str,
           devices: Optional[Sequence[str]] = None, args: Sequence = (),
           timeout: float = DEFAULT_TIMEOUT_S,
           layout: Optional[Tuple[int, int, int]] = None) -> List[Any]:
    """Run ``fn(FrameGroup, *args)`` on ``nprocs`` new processes, one rank
    each, and return what each returned, in rank order.  With ``layout``
    = (data, cfg, frames), whose product is ``nprocs``, ``fn`` takes the
    rank's :class:`Layout` instead of the world's group.  Each rank also
    finds torchrun's RANK, WORLD_SIZE and LOCAL_RANK (= RANK) in its
    environment.

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
                tuple(args), timeout, workdir, layout))
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
