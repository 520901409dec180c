"""What decides ``correct``: the program's outputs of one job against the
plain reference's, number by number, each against its limit
(``limits/<cell>.json``).

The numbers (each a gap from the reference, 0 when equal):

* ``text``: relative L2 of the CLIP embeddings (all 2B+1 rows);
* ``latents``: relative L2 of the VAE-encoded clips with their posterior
  draws;
* ``condition`` (i2v): relative L2 of the encoded condition images;
* ``rep``: relative L2 of the motion representation's top-1 values;
  ``rep_index``: the share of its top-1 positions that differ;
* ``init``: relative L2 of the initial latents against the seed's draw;
* ``guided`` / ``vanilla``: for the checked guided / vanilla steps and
  every example, the relative L2 gap between the program's state after
  the step and the reference's step from the program's state before it
  (latents, text embeddings, motion representation, condition); the
  worst;
* ``guidance``: for the checked guided steps and every example, the
  relative L2 gap of the guidance loss's gradient to the latents (before
  the step's ramp); the worst.  The score moves a step by far less than
  bf16's rounding of it (``guidance_share``), so ``guided`` cannot see it;
* ``decode``: for every example and frame, the mean absolute gap of the
  uint8 frames decoded from the program's final latents; the worst;
* the model family's own numbers (``families/<name>.py``'s ``readings``),
  beside these, under other names.

Every number is judged: a run whose limits do not name exactly the
numbers it read (a limit missing, or one with nothing to judge) is not
correct.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import torch


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def readings(got: Mapping, ref: Mapping,
             family: Optional[Callable[[Mapping, Mapping], Dict[str, float]]] = None
             ) -> Dict[str, float]:
    """The numbers of ``got`` (the program's record, or the control's
    outputs) against ``ref`` (the reference's outputs), with the model
    family's own numbers ``family(got, ref)``, which may not reuse a name."""
    out = {"text": rel_l2(got["text"], ref["text"]),
           "latents": rel_l2(got["latents"], ref["latents"])}
    if ref["condition"] is not None:
        out["condition"] = rel_l2(got["condition"], ref["condition"])
    names = sorted(ref["rep"])
    out["rep"] = rel_l2(torch.cat([got["rep"][k][0].flatten() for k in names]),
                        torch.cat([ref["rep"][k][0].flatten() for k in names]))
    out["rep_index"] = float(torch.cat([
        (got["rep"][k][1].long() != ref["rep"][k][1].long()).flatten() for k in names
    ]).double().mean())
    out["init"] = rel_l2(got["init"], ref["init"])
    for kind in ("guided", "vanilla"):
        gaps = [rel_l2(got["steps"][i][e], want[e])
                for i, want in ref["steps"].items()
                if (i < ref["guided_steps"]) == (kind == "guided")
                for e in range(want.shape[0])]
        if gaps:
            out[kind] = max(gaps)
    gaps = [rel_l2(got["grads"][i][e], want[e]) for i, want in ref["grads"].items()
            for e in range(want.shape[0])]
    if gaps:
        out["guidance"] = max(gaps)
    diff = (got["frames"].cpu().to(torch.int16) - ref["frames"].cpu().to(torch.int16)).abs()
    out["decode"] = float(diff.double().mean(dim=(2, 3, 4)).max())
    own = family(got, ref) if family is not None else {}
    if set(own) & set(out):
        raise ValueError(f"the family's numbers reuse common names: {sorted(set(own) & set(out))}")
    return {**out, **own}


def guidance_share(ref: Mapping) -> float:
    """How far the guidance's score moves the reference's checked guided
    steps: the largest relative L2 gap between a step and the same step
    without the score (printed beside the checks, not judged)."""
    return max((rel_l2(ref["unguided"][i], want) for i, want in ref["steps"].items()
                if i < ref["guided_steps"]), default=0.0)


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """The limits name exactly the numbers read, and every number is finite
    and within its limit (so empty limits judge nothing and fail)."""
    return bool(numbers) and set(numbers) == set(limits) and all(
        math.isfinite(numbers[name]) and numbers[name] <= limit
        for name, limit in limits.items())


def lines(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict]:
    """{name: {"value": reading, "limit": limit or None}} in a fixed order;
    a reading that is not finite is None."""
    return {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                "limit": limits.get(k)} for k in sorted(numbers)}


def program_record(record: Mapping, steps) -> Dict[str, object]:
    """The program's job record in the shape of the reference's outputs:
    a checked step's output is the program's state at the next step, or
    its final latents after the last step."""
    outs = {i: record["states"].get(i + 1, record["final"]) for i in steps}
    return dict(record, init=record["states"][0], steps=outs)
