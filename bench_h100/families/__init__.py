"""Model families: everything of the benchmark that depends on a model's
architecture sits behind one module a family, ``families/<name>.py``.

A configuration file (``configs/<config>.json``) names its family under
``"family"``; a file without that key belongs to ``sd15_animatediff``
(SD1.5's UNet3D with AnimateDiff's motion modules, the SparseCtrl
controlnet, the SD VAE and CLIP ViT-L/14).  The harness core (``run.py``,
``harness.py``, ``check.py``, ``trace.py``, ``metrics/``) reaches a model
only through these functions of the cell's family module, found by name
from the cell's root as a metric's reader is:

``networks(config, device="meta")``
    The plain reference networks, ``{network: nn.Module}`` in float32 with
    uninitialised parameters on ``device``, whose parameter names are the
    program's state-dict keys.  The seeded weights (``weights.make``), the
    reference check and the FLOPs take their networks from here only.
``build_program(config, traffic, tensors, device, lap)``
    The program's pipeline for the configuration, with the seeded weights
    ``tensors`` ({network: {name: tensor}}); ``lap(stage)`` marks the end
    of the program's imports and of its modules.
``denoiser(pipe)``
    The module whose calls are the sampling steps' passes, its first two
    positional arguments the latents (the batch's first rows) and the
    timestep (``harness.StateRecorder`` hooks it).
``words(config)``
    How many ordinary token ids a prompt draws from: ``inputs.py`` draws
    each prompt's ids in ``[0, words)`` from the seed.
``token_ids(config, prompts, device)``
    A job's token ids for each text tower from its prompts (the examples'
    prompts, the negative prompt once an example, the empty prompt, each a
    sequence of drawn ids): how they are framed and padded.
``run_job(pipe, inp, traffic, tracer, recorder=None)``
    One job through the program.  Returns its record: ``marks`` (the
    sampling loop's (kind, mark) pairs, ``harness.mark``), ``frames``
    (B, F, H, W, 3) uint8 on the host, and what the reference reads:
    ``text``, ``latents``, ``condition``, ``rep``, ``final``, ``states``,
    ``grads``, and the family's conditioning object, which only the family
    and its reference slice per example.  It arms ``recorder`` around
    sampling and switches ``tracer``'s step spans.
``warm_up(pipe, inp, traffic)``
    The cell's shapes once, before the window.
``reference(nets, config, traffic, device, inp, program, steps, store)``
    The plain reference's outputs of a job (``check.readings``' keys),
    computed from the inputs and, step by step, from the program's
    ``record``; ``store`` rounds what the program would keep (the
    control's fp8).
``readings(got, ref)``
    The family's own numbers beside ``check.readings``' common ones (a
    pooled embedding, say): ``{}`` where it has none.  Each needs its limit.
``job_flops(config, traffic)``
    ``{..., "job": model FLOPs of one job}``, counted over the plain
    reference on the meta device (``mfu.*``).
``kernels()``
    Kernel entry points beyond ``work/bounds.KERNELS``: ``{(module under
    motionclone_tpu_torch.ops, function): (layer, count)}``, ``count``
    giving a call's (flops, bytes) from its arguments.  The tracer wraps
    them too; an entry may not replace a common one.

**A new configuration is new files and new entries only:**

1. ``configs/<config>.json`` at the published widths, with
   ``"family": "<name>"`` (an existing family's configuration needs no new
   code: its sizes are data);
2. for a new family, ``families/<name>.py`` with the functions above, and
   its plain reference under ``reference/`` (plain PyTorch or NumPy,
   importing nothing of the program: ``tests/test_bench_h100_imports.py``
   scans that directory);
3. ``traffic/<mix>.json`` (read by ``inputs.py``'s one generator) and
   ``limits/<cell>.json`` (one limit for every number the cell reads,
   set from the program's and the control's readings on the card);
4. entries in ``BENCHMARK.json``: the configuration, the cell, and the
   cell's name in the ``workloads`` of each metric it reports;
5. for a new kernel entry point, its entry in the family's ``kernels()``
   with its (flops, bytes) count in the family's files, under a layer
   that a reader ``metrics/<quantity>.py`` reads.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = "sd15_animatediff"
HOOKS = ("networks", "build_program", "denoiser", "words", "token_ids", "run_job", "warm_up",
         "reference", "readings", "job_flops", "kernels")


def load(name: str, root: str):
    """The family module ``name`` of the checkout ``root``: this package's
    own by import, another root's by its path."""
    here = os.path.join(root, "bench_h100", "families")
    path = os.path.join(here, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no family module {path}")
    if os.path.realpath(here) == os.path.realpath(HERE):
        mod = importlib.import_module(f"bench_h100.families.{name}")
    else:
        key = f"bench_h100_family_{hashlib.sha1(path.encode()).hexdigest()[:12]}_{name}"
        mod = sys.modules.get(key)
        if mod is None:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod  # dataclasses look their module up there
            try:
                spec.loader.exec_module(mod)
            except BaseException:
                del sys.modules[key]
                raise
    missing = [h for h in HOOKS if not callable(getattr(mod, h, None))]
    if missing:
        raise SystemExit(f"family {name!r} ({path}) lacks {missing}")
    return mod
