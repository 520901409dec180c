"""Rank bodies of tests/test_torch_layouts.py.

Each runs in a process of its own that ``parallel.frames.launch`` spawns,
as one rank of a gloo group on the CPU.  This module imports no JAX, so that
the ranks start fast, and it holds no tests."""

import json
import os
import threading
import time
import urllib.request

import torch

from motionclone_tpu_torch import cli
from motionclone_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
from motionclone_tpu_torch.parallel.frames import Layout
from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline, make_sampling_fns

# the layouts of the 4 ranks, in the order every rank builds them
PAIR_FRAMES, PAIR_ONLY, DATA_FRAMES = (1, 2, 2), (2, 2, 1), (2, 1, 2)


def _unet(state_dict, cfg):
    unet = UNet3DConditionModel(cfg)
    unet.load_state_dict(state_dict, strict=True)
    return unet.eval()


def _gathered(layout, rep, latents):
    """The whole video's representation and latents from this rank's."""
    group = layout.frame_group
    if group is None:
        return rep, latents
    return ({k: (group.gather_frames(v, 3), group.gather_frames(i, 3))
             for k, (v, i) in rep.items()}, group.gather_frames(latents))


def sampled(layout, state_dict, unet_cfg, sched_cfg, infer_cfg, video_latents, noise, init,
            uncond, cond, controlnet=None, cn_cond=None):
    """Extraction from the whole video, ``sample`` from the rank's frames
    and the first guided step's loss under ``layout``; the representation
    and the latents gathered over the frame group."""
    cn = None
    if controlnet is not None:
        cn = SparseControlNetModel(controlnet["cfg"])
        cn.load_state_dict(controlnet["state_dict"], strict=True)
        cn.eval()
    fns = make_sampling_fns(_unet(state_dict, unet_cfg), sched_cfg, infer_cfg,
                            frame_group=layout.frame_group, controlnet=cn,
                            cfg_pair=layout.pair)
    rep = fns.extract(video_latents, noise, uncond, cn_cond)
    local = init if layout.frame_group is None else layout.frame_group.local_frames(init)
    latents = fns.sample(local, uncond, cond, rep, cn_cond=cn_cond)
    t, tp = (int(x) for x in fns.timesteps[:2])
    _, loss = fns.guided_step(local, t, tp, 1.0, uncond, cond, rep, cn_cond)
    refused = None
    if cn is not None:
        try:
            fns.sample(local, uncond, cond, rep)
        except ValueError as e:
            refused = str(e)
    rep, latents = _gathered(layout, rep, latents)
    return {"rep": rep, "latents": latents, "loss": float(loss), "refused": refused}


def plain_probs_rank(group, state_dict, unet_cfg, sched_cfg, infer_cfg, init, uncond, cond):
    """``sample_plain_probs`` (chunks of 3 steps) with the two ranks as a
    frame group and as a CFG pair -> {"frames": ..., "pair": ...}, each
    (the latents gathered over the frames, the dump)."""
    torch.set_num_threads(1)  # several ranks share the test worker's cores
    pair = Layout.build(1, 2, 1, backend="gloo").pair
    unet = _unet(state_dict, unet_cfg)
    out = {}
    for name, kw in (("frames", dict(frame_group=group)), ("pair", dict(cfg_pair=pair))):
        fns = make_sampling_fns(unet, sched_cfg, infer_cfg, **kw)
        local = init if fns.frame_group is None else group.local_frames(init)
        latents, probs = fns.sample_plain_probs(local, uncond, cond, chunk_steps=3)
        if fns.frame_group is not None:
            latents = group.gather_frames(latents)
        out[name] = (latents, probs)
    return out


def layouts_rank(pair_frames, cases):
    """Every layout of the 4 ranks on this rank: (a) cfg 2 x frames 2 (the
    layout ``launch`` built), (b) data 2 x cfg 2 (data group d runs
    ``cases["b"][d]``), (c) data 2 x frames 2 with a controlnet (data group
    d runs flavour d) and (d) the same layout without one, data group d
    sampling example d alone and the batch of both examples."""
    torch.set_num_threads(1)  # several ranks share the test worker's cores
    layouts = {PAIR_FRAMES: pair_frames}
    layouts.update({spec: Layout.build(*spec, backend="gloo") for spec in
                    (PAIR_ONLY, DATA_FRAMES)})
    data_frames = layouts[DATA_FRAMES]
    d = data_frames.data_index
    sweep = cases["d"]
    alone = {k: (v[d: d + 1] if torch.is_tensor(v) and v.dim() >= 2 else v)
             for k, v in sweep.items()}
    return {
        "rank": pair_frames.rank,
        "a": sampled(layouts[PAIR_FRAMES], **cases["a"]),
        "b": sampled(layouts[PAIR_ONLY], **cases["b"][layouts[PAIR_ONLY].data_index]),
        "c": sampled(data_frames, **cases["c"][d]),
        "d_alone": sampled(data_frames, **alone)["latents"],
        "d_batch": sampled(data_frames, **sweep)["latents"],
        "where": {"pair_frames": (layouts[PAIR_FRAMES].pair.rank,
                                  layouts[PAIR_FRAMES].frame_group.rank),
                  "data_index": d, "video_lead": data_frames.is_lead},
    }


# ---------------------------------------------------------------------------
# the CLIs under 2 ranks
# ---------------------------------------------------------------------------


def _keep_gathered(seen):
    """Keep what ``gather_latents`` returns: every rank's whole latents."""
    gather = MotionClonePipeline.gather_latents

    def spy(self, latents):
        out = gather(self, latents)
        seen.append(out.clone())
        return out

    MotionClonePipeline.gather_latents = spy


def _checksum(rt):
    """Every loaded parameter's sum in float64, by name."""
    mods = dict(unet=rt.pipeline.unet, vae=rt.pipeline.vae, clip=rt.pipeline.text_encoder,
                cn=rt.pipeline.controlnet)
    return {f"{m}.{k}": float(v.double().sum()) for m, mod in mods.items() if mod is not None
            for k, v in mod.state_dict().items()}


def _serve(argv, job):
    """``serve_main`` on this rank; rank 0 serves in a thread of its own,
    posts ``job`` to itself, waits for it and stops the server."""
    if int(os.environ["RANK"]) != 0:
        cli.serve_main(argv)
        return None
    servers = []
    main = threading.Thread(target=cli.serve_main, kwargs=dict(argv=argv, ready=servers.append))
    main.start()
    deadline = time.monotonic() + 120
    while not servers and main.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    port = servers[0].port
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(job).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        job_id = json.loads(resp.read())["job_id"]
    record = None
    while time.monotonic() < deadline + 240:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/jobs/{job_id}", timeout=30) as r:
            record = json.loads(r.read())
        if record["status"] in ("done", "failed"):
            break
        time.sleep(0.1)
    servers[0].shutdown()
    main.join(60)
    return {"record": record, "joined": not main.is_alive()}


def clis_rank(world, root, argvs, job):
    """Each of ``argvs`` (t2v, i2v, sweep, sweep_pair: their CLI's argv)
    then the server under ``job``, from ``root``, on this rank; returns
    their paths, the gathered latents, the weights-cache state and the
    parameters' checksums of the t2v run, and the served job's record."""
    torch.set_num_threads(1)
    os.chdir(root)
    out = {"rank": world.rank}
    for name, main in (("t2v", cli.t2v_main), ("i2v", cli.i2v_main),
                       ("sweep", cli.sweep_main), ("sweep_pair", cli.sweep_main)):
        seen = []
        gather = MotionClonePipeline.gather_latents
        _keep_gathered(seen)
        try:
            rt, paths = main(argvs[name])
        finally:
            MotionClonePipeline.gather_latents = gather
        out[name] = {"paths": paths, "latents": seen[-1], "cache": rt.weights_cache_state,
                     "checksum": _checksum(rt) if name == "t2v" else None}
    seen = []
    gather = MotionClonePipeline.gather_latents
    _keep_gathered(seen)
    try:
        out["serve"] = _serve(argvs["serve"], job)
    finally:
        MotionClonePipeline.gather_latents = gather
    out["serve_latents"] = seen[-1] if seen else None
    return out
