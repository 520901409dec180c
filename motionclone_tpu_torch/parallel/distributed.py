"""Share-nothing sweeps over several processes, one card each.

Port of ``motionclone_tpu/parallel/distributed.py``.  The examples of a
sweep are independent (their own seeds, prompts and reference videos), so
the multi-process design is the JAX package's share-nothing one: every
process takes its stride of the examples (:func:`partition_examples`) and
sweeps them on its own card.  No collective is issued, so no process group
is made and nothing rendezvouses: a slow rank delays only its own share.

A process learns its rank and the world's size from the command line
(``--num-processes N --process-id I``; ``--coordinator HOST:PORT`` is
accepted for the JAX CLI's sake and contacted by nobody) or from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  Each rank runs on
``cuda:LOCAL_RANK`` (``LOCAL_RANK`` unset: 0) unless ``--device`` names
another device than ``cuda``.

Under ``--frame-shard`` / ``--cfg-pair`` a sweep's unit of work is a data
group of ranks instead of one rank (``parallel/frames.Layout``, the JAX
package's (data, [cfg,] frames) mesh): data group d of D sweeps
``partition_examples(examples, d, D)``, and the groups stay share-nothing.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, TypeVar

T = TypeVar("T")


def partition_examples(
    examples: Sequence[T],
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[T]:
    """This process's share of a sweep: ``examples[pid::count]``, the rank
    and the count from torchrun's ``RANK`` and ``WORLD_SIZE`` where not
    given (0 and 1 without them).

    A stride (round-robin) split keeps the ranks' example counts within one
    of each other, and spreads the cost of a group of expensive examples
    (JSONL files group their workloads) over the ranks."""
    pid = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    count = int(os.environ.get("WORLD_SIZE", 1)) if process_count is None else process_count
    if not 0 <= pid < count:
        raise ValueError(f"process_id {pid} out of range for {count} processes")
    return list(examples[pid::count])


def maybe_initialize_from_args(args) -> bool:
    """CLI glue: read this process's rank and the world's size from the
    flags (``coordinator``, ``num_processes``, ``process_id``,
    ``distributed``) or torchrun's environment into ``args.process_id`` and
    ``args.num_processes``, and point ``args.device`` at the rank's card.
    Returns True when running multi-process (the caller then sweeps
    :func:`partition_examples`' share only)."""
    explicit = bool(getattr(args, "coordinator", None)
                    or getattr(args, "num_processes", 0) > 1)
    env = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if not (explicit or env or getattr(args, "distributed", False)):
        return False
    if explicit:
        count, pid = getattr(args, "num_processes", 0), getattr(args, "process_id", -1)
        if count < 1 or pid < 0:
            raise ValueError("a distributed run from flags needs --num-processes N and "
                             "--process-id I on every process")
    elif env:
        count, pid = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise ValueError(
            "distributed run requested but no launcher was detected; run under torchrun "
            "(RANK, WORLD_SIZE, LOCAL_RANK) or pass --num-processes N --process-id I")
    if not 0 <= pid < count:
        raise ValueError(f"process_id {pid} out of range for {count} processes")
    args.process_id, args.num_processes = pid, count
    if getattr(args, "device", None) == "cuda":
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return count > 1
