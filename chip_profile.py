"""Where the time of the port's paths goes, on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_profile.py

It drives the search path of ``chip_smoke.py`` (full-size EfficientNet-B0
on the four-platform chain, ``torch_nsga2`` at population 16384 for 10
generations) four times:

1. once to warm up (kernel build, allocator, lazy CUDA state);
2. once untimed inside, for the wall time;
3. once with synchronized host timers around each stage of the generation
   loop (offspring, evaluation, the tiled domination kernel, front peeling,
   the whole ranking, crowding, survivor selection, the final-front
   kernel), plus the number of fronts each ranking peels;
4. once under ``torch.profiler`` (CPU and CUDA activities): the device-busy
   share of the wall time, the kernels with the most device time, and the
   device time of the two Pareto kernels (K1 ``packed_domination``, K2
   ``domination_counts``) with each launch's time.

``python3 chip_profile.py --search`` stops there; ``--serve`` runs only
:func:`serve_profile` (the serve path of ``chip_smoke.py`` phase 12), and
``--train`` only :func:`train_profile` (a train step of smollm-360m at
full width, ``chip_smoke.py`` phase 13), and ``--optim`` only
:func:`optim_compare` (the multi-tensor AdamW against the same rules a
leaf at a time, in the LM's and the oracle's train steps), and ``--moe``
only deepseek-moe-16b at full width and depth (``chip_smoke.py`` phase
16): the forward of 2 x 2048 tokens and the generation of 16 tokens for
8 prompts of 128 under the profiler, with the shares of the matrix
products, the dispatch's indexing, the routing and the elementwise
passes.  ``--families`` only the audio and vlm families at full size
(``chip_smoke.py`` phase 17): qwen2-vl-7b's forward of 2 x (256 patches +
7936 tokens) through the window kernel and its generation of 32 tokens
for 8 text prompts of 128, then musicgen-large's forward of 4 clips of
1500 frames and 20 greedy frames for 8 prompts of 250 through
``decode_step``, each under the profiler with the window kernel's and the
matrix products' shares.
``--pipeline`` only the pipeline of ``chip_smoke.py`` phase 18
(smollm-360m at full width, 4 prompts of 8192 tokens): the monolithic
forward, then ``pipelined_apply`` at 2 and at 4 stages over 4
microbatches, each under the profiler with the device's busy share (the
union of the kernels' intervals over the wall), the kernels' summed time
beside it (their difference is the time kernels of two streams ran at
once) and each stream's device time and launches.
``--cold`` instead runs ``chip_smoke.py``'s phases 1-3 as that script does, with the stage
timers on the phase-3 search (the first search of the process), then the
same search again warm.  The search part needs
of ``chip_smoke.py`` only ``main_spec`` and ``card_line``, so a copy of
this file beside an older tree's ``chip_smoke.py`` times that tree's search
the same way.

The stage timers synchronize the device around every stage, so the third
run can be slower than the second; its stage shares are what it is for.

Then it drives the LM path of ``chip_smoke.py`` (smollm-360m at full width)
under ``torch.profiler``, after one warm-up of each piece: the forward of
two 8192-token prompts through the sliding-window kernel, and the
generation of 32 tokens for 8 prompts of 128 (prefill and decode through
the KV cache).  For each: wall time, device-busy share, kernel launches,
the kernels with the most device time, and the shares of the window kernel
and of the matrix products.

Last it drives the SSM path of ``chip_smoke.py`` (mamba2-370m at full width
and depth) the same way: the forward of two 8192-token prompts through the
SSD scan kernel, and the generation (prefill and decode through the SSM
caches, no kernel).  For each it also gives the SSD scan kernel's share and
the matrix products' share of the device time, and for the forward each of
the scan's five launches (``ssd_*``) with its time.

Then the accuracy path of ``chip_smoke.py`` (EfficientNet-B0 at 224, 256
synthetic images, seeded weights): the monolithic forward, the partitioned
fake-quantized forward at the widest cut vector of the search's front
(four platforms: weights at 16, 16, 8 and 8 bits, link activations
quantized to the producer's width), and the link fake-quant passes of
``quantize_tensor`` alone, each under the profiler, with the shares of the
convolutions, the depthwise convolutions, BatchNorm, the elementwise
passes and the reductions.

Last the int8 product kernel at VGG-16's first classifier layer (M 256,
K 25088, N 4096), where it is slower than its plain version: its two
launches under the profiler with the launch figures of the profiler's
trace (grid, registers per thread, blocks per SM, estimated achieved
occupancy), and its time and ``torch._int_mm``'s as M grows at the same K
and N.  That part alone:

    python3 -c 'import chip_profile; chip_profile.qmm_profile()'
"""

from __future__ import annotations

import collections
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import chip_smoke  # noqa: E402

# the ignored build directory: the pipeline's trace
BUILD = Path(__file__).resolve().parent / "build"
STAGES = collections.OrderedDict()
FRONTS = []


def _timed(name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        STAGES[name] = STAGES.get(name, 0.0) + time.perf_counter() - t
        return out
    return wrapper


def instrument():
    """Wrap the generation loop's stages in synchronized timers."""
    from repro_torch.core import nsga2_torch, partition_torch
    from repro_torch.kernels import ops

    peel = nsga2_torch._peel

    def counting_peel(*args):
        out = peel(*args)
        FRONTS.append(out[1])
        return out

    nsga2_torch._peel = _timed("peel fronts (K6 on the card)",
                               counting_peel)
    ops.packed_domination = _timed("packed_domination kernel",
                                   ops.packed_domination)
    ops.domination_counts = _timed("domination_counts kernel (final front)",
                                   ops.domination_counts)
    rank = nsga2_torch.nondominated_rank
    nsga2_torch.nondominated_rank = _timed("ranking total", rank)
    for name in ("make_offspring", "crowding_by_rank", "survivors"):
        setattr(nsga2_torch, name, _timed(name, getattr(nsga2_torch, name)))
    make_eval = partition_torch.make_runtime_eval_fn

    def timed_make_eval(*args, **kwargs):
        return _timed("evaluation", make_eval(*args, **kwargs))

    partition_torch.make_runtime_eval_fn = timed_make_eval


def search_profile(dev):
    """The search path's four runs (warm-up, untimed, stage-timed,
    profiled, with K1's and K2's device time); returns the last result."""
    from repro_torch.explore import run_spec

    spec = chip_smoke.main_spec()
    t = time.perf_counter()
    run_spec(spec, device=str(dev))
    torch.cuda.synchronize()
    print(f"warm-up run (includes the kernel build): "
          f"{time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    run_spec(spec, device=str(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"untimed run: wall {wall:.3f} s")

    instrument()
    stage_timed("stage-timed run", lambda: run_spec(spec, device=str(dev)))

    return profiled("search run", lambda: run_spec(spec, device=str(dev)),
                    groups={
                        "K1 packed_domination_kernel":
                            lambda k: "packed_domination" in k,
                        "K2 domination_counts_kernel":
                            lambda k: "domination_counts" in k},
                    each=lambda k: "domination" in k)


def stage_timed(label, fn):
    """``fn()`` (a search, with :func:`instrument` on): its wall and each
    stage's seconds and share, then the timers cleared."""
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"{label}: wall {wall:.3f} s")
    for name, s in STAGES.items():
        print(f"  {name:42s} {s:8.3f} s  {100 * s / wall:5.1f} %")
    inner = sum(s for n, s in STAGES.items() if n != "ranking total")
    print(f"  {'outside the timed stages (host set-up)':42s} "
          f"{wall - inner:8.3f} s")
    print(f"  fronts peeled per ranking call: {FRONTS}")
    STAGES.clear()
    FRONTS.clear()


def cold_search(dev):
    """``chip_smoke.py``'s phases 1-3 as it runs them, with the stage
    timers on phase 3's search (the first search of the process), then the
    same search again, warm."""
    from repro_torch.explore import run_spec
    from repro_torch.kernels import _build
    _build.build_all()
    chip_smoke.check_kernels(dev)
    chip_smoke.check_ranking(dev)
    spec = chip_smoke.main_spec()
    instrument()
    for label in ("cold search (phase 3 of chip_smoke.py)", "warm search"):
        stage_timed(label, lambda: run_spec(spec, device=str(dev)))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # the numerics of chip_smoke.py: float32 products and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line())
    if "--cold" in argv:
        cold_search(dev)
        return 0
    if "--train" in argv:
        train_profile(dev)
        return 0
    if "--optim" in argv:
        optim_compare(dev)
        return 0
    if "--moe" in argv:
        lm_profile(dev, chip_smoke.MOE_ARCH, groups=MOE_GROUPS,
                   b=chip_smoke.MOE_B, t=chip_smoke.MOE_T,
                   new=chip_smoke.MOE_NEW)
        return 0
    if "--families" in argv:
        family_profile(dev)
        return 0
    if "--pipeline" in argv:
        pipeline_profile(dev)
        return 0
    res = search_profile(dev)
    if "--serve" in argv:
        serve_profile(dev)
        return 0
    if "--search" in argv:
        return 0
    lm_profile(dev, chip_smoke.LM_ARCH, groups=LM_GROUPS)
    lm_profile(dev, chip_smoke.SSM_ARCH, groups={
        "SSD scan kernel (ssd_*)": lambda k: "ssd_" in k,
        "matrix products (*gemm*)": lambda k: "gemm" in k.lower()},
        each=lambda k: "ssd_" in k)
    cnn_profile(dev, [p.cuts for p in res.pareto])
    qmm_profile(dev)
    return 0


# kernel groups of the moe family's forward and decode (by CUDA kernel name)
MOE_GROUPS = {
    "matrix products (*gemm*)": lambda k: "gemm" in k.lower(),
    "indexing: dispatch, combine (index*, gather, scatter)": lambda k: any(
        w in k.lower() for w in ("index", "gather", "scatter")),
    "routing: top-k, sort, softmax": lambda k: any(
        w in k.lower() for w in ("topk", "sort", "softmax", "radix")),
    "elementwise": lambda k: "elementwise" in k.lower(),
}


def profiled(label, fn, top_n=12, groups=None, each=None):
    """Run ``fn`` once under ``torch.profiler``; print the wall time, the
    device-busy share, the kernels with the most device time and, for each
    of ``groups`` (label -> test of a kernel's name), its device time and
    share of the busy time; then every kernel that ``each`` accepts, with
    its time a launch.  Returns what ``fn`` returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    # device-side entries only: a CPU operator's device time repeats the
    # time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{label} (profiled): wall {prof_wall:.3f} s, device busy "
          f"{device_s:.3f} s = {100 * device_s / prof_wall:.1f} % of wall, "
          f"{sum(e.count for e in kernels)} kernel launches")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:top_n]
    for e in top:
        print(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.2f} ms"
              f"  x{e.count}")
    for name, test in (groups or {}).items():
        mine = [e for e in kernels if test(e.key)]
        s = sum(e.self_device_time_total for e in mine) / 1e6
        print(f"  {name}: {s * 1e3:.2f} ms = {100 * s / device_s:.1f} % of "
              f"the busy time, {sum(e.count for e in mine)} launches")
    for e in kernels:
        if each is not None and each(e.key):
            print(f"    {e.key[:66]:66s} {e.self_device_time_total / 1e3:8.2f}"
                  f" ms, x{e.count}, "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms each")
    return out



def stream_profiled(label, fn):
    """Run ``fn`` once under ``torch.profiler``; print its wall, the
    device's busy share (the union of the kernels' intervals, read from
    the Chrome trace), the kernels' summed time and each CUDA stream's
    device time and launches, streams in the order of their first kernel.
    Returns what ``fn`` returns."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    BUILD.mkdir(exist_ok=True)
    path = BUILD / "pipeline_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, None
    for a, b in spans:                       # the union of the intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    total = sum(e["dur"] for e in events)
    streams = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        sid = e.get("args", {}).get("stream", e.get("tid"))
        acc = streams.setdefault(sid, [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    print(f"{label} (profiled): wall {wall:.3f} s, device busy "
          f"{busy / 1e6:.3f} s = {100 * busy / 1e6 / wall:.1f} % of wall; "
          f"kernels' summed time {total / 1e6:.3f} s (overlap of streams "
          f"{(total - busy) / 1e6:.3f} s), {len(events)} launches")
    for sid, (us, n) in streams.items():
        print(f"  stream {sid}: {us / 1e3:.2f} ms of device time, {n} "
              f"launches")
    return out


def pipeline_profile(dev):
    """``chip_smoke.py`` phase 18's forwards under the profiler: the
    monolithic forward, then the pipeline at each stage count."""
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.launch.pipeline import pipelined_apply, stack_stages
    from repro_torch.models.registry import build_model, get_config
    import numpy as np
    cfg = get_config(chip_smoke.LM_ARCH)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(chip_smoke.SEED))
    rng = np.random.default_rng(chip_smoke.SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (chip_smoke.PIPE_B, chip_smoke.LM_T))).to(dev)}
    runs = [("monolithic forward", lambda: model(batch, impl="cuda"))]
    for n_stages in chip_smoke.PIPE_STAGES:
        stages = stack_stages(model, n_stages)
        mesh = make_stage_mesh(n_stages, dev)
        runs.append((f"pipelined, {n_stages} stages x "
                     f"{chip_smoke.PIPE_M} microbatches",
                     lambda stages=stages, mesh=mesh: pipelined_apply(
                         model, stages, batch, mesh, chip_smoke.PIPE_M,
                         impl="cuda")))
    with torch.no_grad():
        for label, fn in runs:
            fn()                                   # warm-up
            torch.cuda.synchronize()
            stream_profiled(f"{chip_smoke.LM_ARCH} {chip_smoke.PIPE_B} x "
                            f"{chip_smoke.LM_T} tokens, {label}", fn)
            torch.cuda.empty_cache()


def lm_profile(dev, arch, groups=None, each=None,
               b=chip_smoke.LM_B, t=chip_smoke.LM_T,
               new=chip_smoke.GEN_NEW, batch_fn=None):
    """The forward of ``b`` x ``t`` tokens (``batch_fn(cfg, rng)``'s batch
    when given) and the generation of ``new`` tokens for
    ``chip_smoke.GEN_REQUESTS`` prompts of ``GEN_PROMPT`` by ``arch`` (an
    LM path of ``chip_smoke.py``) under the profiler; ``groups`` and
    ``each`` as in :func:`profiled`."""
    import numpy as np

    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serving import GenerationEngine

    cfg = get_config(arch)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(chip_smoke.SEED))
    rng = np.random.default_rng(chip_smoke.SEED)
    if batch_fn is None:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (b, t))).to(dev)}
    else:
        batch = batch_fn(cfg, rng)
        t = batch["positions3"].shape[-1]
    prompts = rng.integers(0, cfg.vocab, (chip_smoke.GEN_REQUESTS,
                                          chip_smoke.GEN_PROMPT))
    engine = GenerationEngine(model, max_seq=chip_smoke.GEN_PROMPT + new)

    def forward():
        with torch.no_grad():
            model(batch, impl="cuda")

    def generate():
        gen = engine.generate(prompts, max_new=new)
        print(f"  prefill {gen.prefill_s:.3f} s, decode {gen.decode_s:.3f} s "
              f"({gen.tokens_per_s:.1f} tok/s)")

    forward()
    engine.generate(prompts, max_new=2)
    torch.cuda.synchronize()
    profiled(f"{arch} forward {b} x {t} tokens", forward, groups=groups,
             each=each)
    profiled(f"{arch} generation {chip_smoke.GEN_REQUESTS} x "
             f"{chip_smoke.GEN_PROMPT} + {new}", generate, groups=groups)



LM_GROUPS = {
    "sliding-window attention kernel (window_attn)":
        lambda k: "window_attn" in k,
    "matrix products (*gemm*)": lambda k: "gemm" in k.lower()}


def family_profile(dev, audio_new=20):
    """qwen2-vl-7b's forward (K5 in every block) and generation, then
    musicgen-large's forward and ``audio_new`` greedy frames through
    ``decode_step``, at ``chip_smoke.py`` phase 17's inputs, each model
    freed before the next."""
    import numpy as np

    from repro_torch.models.registry import build_model, get_config

    lm_profile(dev, chip_smoke.VLM_ARCH, groups=LM_GROUPS,
               b=chip_smoke.VLM_B, batch_fn=lambda cfg, rng: chip_smoke
               .vlm_batch(cfg, chip_smoke.VLM_B,
                          chip_smoke.VLM_T - cfg.n_patches, rng, dev))
    torch.cuda.empty_cache()
    cfg = get_config(chip_smoke.AUDIO_ARCH)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(chip_smoke.SEED))
    rng = np.random.default_rng(chip_smoke.SEED)
    codes = torch.from_numpy(rng.integers(0, cfg.vocab, (
        chip_smoke.AUDIO_B, cfg.n_codebooks, chip_smoke.AUDIO_T))).to(dev)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (
        chip_smoke.AUDIO_REQUESTS, cfg.n_codebooks,
        chip_smoke.AUDIO_PROMPT))).to(dev)

    @torch.no_grad()
    def forward():
        model({"codes": codes})

    @torch.no_grad()
    def decode(n=audio_new):
        caches = model.init_caches(chip_smoke.AUDIO_REQUESTS,
                                   chip_smoke.AUDIO_PROMPT + n,
                                   torch.float32)
        logits, caches = model.decode_step(caches, {"codes": prompts})
        for _ in range(n):
            nxt = logits[:, -1].argmax(-1)[:, :, None]
            logits, caches = model.decode_step(caches, {"codes": nxt})

    forward()
    decode(2)
    torch.cuda.synchronize()
    profiled(f"{chip_smoke.AUDIO_ARCH} forward {chip_smoke.AUDIO_B} x "
             f"{chip_smoke.AUDIO_T} frames", forward, groups=LM_GROUPS)
    profiled(f"{chip_smoke.AUDIO_ARCH} prefill {chip_smoke.AUDIO_REQUESTS} "
             f"x {chip_smoke.AUDIO_PROMPT} + {audio_new} frames decoded",
             decode, groups=LM_GROUPS)


def serve_profile(dev):
    """The serve path of ``chip_smoke.py`` phase 12 (smollm-360m at full
    width, two stages cut after block 15): one wave decode step of a stage
    alone in one thread (host wall a step, then under the profiler: device
    busy share and launches a step), then phase 12's burst through one and
    through two replicas, async and serial (tok/s, each stage's occupancy
    a wave step)."""
    from repro_torch.core.link import get_link
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.serve import (PipelineServeEngine, ReplicaRouter,
                                   Request, ServeLink, poisson_traffic)
    from repro_torch.serving import PartitionedLMRunner
    from repro_torch.serving.engine import _bump_pos

    cs = chip_smoke
    cfg = get_config(cs.LM_ARCH)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(cs.SEED))
    runner = PartitionedLMRunner(model, [cfg.n_layers // 2 - 1])
    capacity = cs.GEN_PROMPT + cs.GEN_NEW
    lanes = cs.SERVE_SLOTS // cs.SERVE_GROUPS
    fn, w = runner.stage_step_fn(0), runner.stage_weights(0)
    caches = _bump_pos(runner.init_stage_caches(0, lanes, capacity,
                                                lanes=True))
    tok = torch.zeros((lanes, 1), dtype=torch.int64, device=dev)
    steps = 20

    def decode_steps():
        nonlocal caches
        for _ in range(steps):
            _, caches = fn(w, caches, tok)
        torch.cuda.synchronize()

    decode_steps()
    t = time.perf_counter()
    decode_steps()
    wall = time.perf_counter() - t
    print(f"serve: stage 0 ({runner.ranges[0]}) wave decode step, {lanes} "
          f"lanes, one thread: {wall / steps * 1e3:.2f} ms a step of host "
          f"wall over {steps} steps")
    profiled(f"serve: stage 0 wave decode x {steps}", decode_steps, top_n=6)

    reqs = [Request(r.rid, r.prompt, r.max_new, 0.0) for r in poisson_traffic(
        cs.SERVE_REQUESTS, rate_rps=cs.SERVE_RPS, vocab=cfg.vocab,
        prompt_len=cs.GEN_PROMPT, max_new=cs.SERVE_NEW, seed=cs.SERVE_SEED)]
    for n_rep in (1, 2):
        for mode in ("async", "serial"):
            replicas = [PipelineServeEngine(
                runner, n_slots=cs.SERVE_SLOTS, n_groups=cs.SERVE_GROUPS,
                mode=mode, capacity=capacity, name=f"replica{i}",
                links=[ServeLink(model=get_link(cs.SERVE_LINK))])
                for i in range(n_rep)]
            for eng in replicas:
                eng.warmup(prompt_len=cs.GEN_PROMPT)
            burst = reqs[:cs.SERVE_SLOTS * n_rep]
            rep = ReplicaRouter(replicas).serve(burst, realtime=False,
                                                max_wall_s=600.0)
            assert rep.n_done == len(burst)
            occ = [st["stage_step_s"] for st in (e.stats for e in replicas)]
            print(f"serve: {n_rep} replica(s) {mode}, {len(burst)} requests "
                  f"x {cs.SERVE_NEW}: {rep.summary()['tokens_per_s']} "
                  f"tok/s, wall {rep.wall_s:.3f} s, stage_step_s {occ}, "
                  f"measured steps/s "
                  f"{[e.stats['measured_steps_per_s'] for e in replicas]}")


def train_profile(dev):
    """Where a train step of smollm-360m at full width goes (phase 13's
    AdamW step at 8 x 128 tokens): synchronized host timers around the
    forward and loss, the backward and the optimizer step, with remat on
    (as configured) and off (the backward's difference is the recompute);
    then one whole step under the profiler: device-busy share, launches,
    the matrix products against the elementwise passes, the reductions
    and the copies.  Then the same for a step of the ``cnn_fakequant``
    oracle's training (:func:`oracle_profile`)."""
    from repro_torch.data.synthetic import make_batch_for
    from repro_torch.models.convert import reference_leaves
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                                   stacked_grads, stacked_params,
                                   warmup_cosine)
    from repro_torch.training import init_params, lm_loss, make_train_step

    cfg = get_config(chip_smoke.LM_ARCH)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(chip_smoke.SEED))
    steps = chip_smoke.TRAIN_STEPS
    opt = adamw(warmup_cosine(chip_smoke.TRAIN_LR, steps // 10, steps))
    step = make_train_step(model, cfg, opt)
    state = opt.init(init_params(model))
    batch = make_batch_for(cfg, chip_smoke.TRAIN_B, chip_smoke.TRAIN_T)
    labels = torch.as_tensor(batch["labels"], device=dev)
    leaves = reference_leaves(model)
    for _ in range(2):                                     # warm-up
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    def parts(remat, reps=3):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        nonlocal state
        times = collections.defaultdict(list)
        for _ in range(reps):
            t = [time.perf_counter()]
            loss = lm_loss(cfg, model(batch, train=True),
                           {"labels": labels}, {})[0]
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            loss.backward()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            grads, _ = clip_by_global_norm(stacked_grads(leaves), 1.0)
            with torch.no_grad():
                upd, state = opt.update(grads, state, stacked_params(leaves))
                apply_updates(leaves, upd)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for name, a, b in zip(("forward + loss", "backward",
                                   "optimizer (clip, update, apply)"),
                                  t, t[1:]):
                times[name].append(round((b - a) * 1e3, 2))
        model.cfg = cfg
        return times

    on, off = parts(True), parts(False)
    for name in on:
        print(f"train step part, {name}: remat on {on[name]} ms, off "
              f"{off[name]} ms")
    med = {k: sorted(v)[len(v) // 2] for k, v in on.items()}
    recompute = med["backward"] - sorted(off["backward"])[1]
    print(f"recompute (backward with remat less without): {recompute:.2f} "
          f"ms; step with remat {sum(med.values()):.2f} ms")

    def one():
        nonlocal state
        state, _ = step(state, batch)

    profiled(f"{chip_smoke.LM_ARCH} AdamW train step {chip_smoke.TRAIN_B} x "
             f"{chip_smoke.TRAIN_T} tokens, remat on", one, top_n=15,
             groups=TRAIN_GROUPS)
    del model, state, step
    oracle_profile(dev)


def oracle_profile(dev):
    """A step of the ``cnn_fakequant`` oracle's training (EfficientNet-B0
    at full width on 64 images of 32 x 32, AdamW over its unstacked
    leaves): forward, backward and optimizer by synchronized host timers,
    the mean of 10 whole steps, then one step under the profiler."""
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.models.cnn.zoo import build_cnn
    from repro_torch.models.convert import reference_leaves
    from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                                   stacked_grads, stacked_params,
                                   warmup_cosine)
    from repro_torch.training import (cross_entropy, init_params,
                                      make_classifier_train_step)

    model = build_cnn("efficientnet_b0", **chip_smoke.FQ_OPTS).init_weights(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    total = chip_smoke.FQ_STEPS
    opt = adamw(warmup_cosine(2e-3, total // 10, total))
    state = opt.init(init_params(model))
    step = make_classifier_train_step(model, opt)
    ds = SyntheticImages(noise=0.2)
    x, y = ds.batch(64, 0)
    for _ in range(3):                                     # warm-up
        state, _ = step(state, x, y)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        state, _ = step(state, x, y)
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t) / 10 * 1e3
    leaves = reference_leaves(model)
    xd, yd = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    t = [time.perf_counter()]
    model.train()
    loss = cross_entropy(model(xd), yd)
    model.eval()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    loss.backward()
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    grads, _ = clip_by_global_norm(stacked_grads(leaves), 1.0)
    with torch.no_grad():
        upd, state = opt.update(grads, state, stacked_params(leaves))
        apply_updates(leaves, upd)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ms = [round((b - a) * 1e3, 2) for a, b in zip(t, t[1:])]
    print(f"cnn_fakequant oracle step (efficientnet_b0 "
          f"{chip_smoke.FQ_OPTS}, batch 64, {len(leaves)} leaves): "
          f"{whole:.2f} ms a step over 10; forward + loss {ms[0]} ms, "
          f"backward {ms[1]} ms, optimizer (clip, update, apply) {ms[2]} ms")

    def one():
        nonlocal state
        state, _ = step(state, x, y)

    profiled("cnn_fakequant oracle train step", one, top_n=10, groups={
        **TRAIN_GROUPS,
        "convolutions (*conv*)": lambda k: "conv" in k.lower(),
        "BatchNorm (*batch_norm*, *bn_*)":
            lambda k: "batch_norm" in k.lower() or "bn_" in k.lower()})


def per_leaf_adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01):
    """``repro_torch.optim.adamw``'s rules with a leaf at a time in each
    elementwise operation (the multi-tensor version takes every leaf at
    once): the same operations in the same order on each element, the
    other dispatch.  With :func:`per_leaf_clip` and
    :func:`per_leaf_apply`."""
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import Optimizer, _to_schedule

    sched = _to_schedule(lr)

    def update(grads, state, params):
        step = state["step"] + 1
        t = step.float()
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        lr_t = sched(step)
        m, v, out = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            m[k] = state["m"][k] * b1
            m[k].add_(g * (1 - b1))
            v[k] = state["v"][k] * b2
            v[k].add_((g * g) * (1 - b2))
            den = torch.sqrt(v[k] / bc2)
            den.add_(eps)
            u = (m[k] / bc1) / den
            if weight_decay and params[k].dim() >= 2:
                u.add_(params[k].float() * weight_decay)
            out[k] = u * -lr_t
        return out, {"m": m, "v": v, "step": step}

    return Optimizer(adamw(lr).init, update)


def per_leaf_clip(grads, max_norm):
    norms = [torch.linalg.vector_norm(g.float()) for g in grads.values()]
    gn = torch.sqrt(torch.sum(torch.square(torch.stack(norms))))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gn


@torch.no_grad()
def per_leaf_apply(leaves, updates):
    for k, leaf in leaves.items():
        for p, u in zip(leaf.params, leaf.unstack(updates[k])):
            p.add_(u)


def optim_compare(dev, rounds=3):
    """The port's multi-tensor AdamW (``torch._foreach_*`` over every
    reference leaf; clip and apply likewise) against the same rules a leaf
    at a time (:func:`per_leaf_adamw`), in one process on one optimizer
    state that both advance: a smollm-360m step at full width (8 x 128,
    remat on, phase 13's peak learning rate) and a ``cnn_fakequant``
    oracle step (EfficientNet-B0 at ``chip_smoke.FQ_OPTS``, batch 64).
    First both variants' updates from one gradient and state (their
    largest difference); then ``rounds`` rounds of multi-tensor, per-leaf,
    each a block of whole steps (host wall between synchronizes, and the
    peak device memory of the block) and the optimizer alone on fixed
    gradients (clip, update, apply; CUDA events)."""
    from repro_torch.data.synthetic import SyntheticImages, make_batch_for
    from repro_torch.models.cnn.zoo import build_cnn
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.training import cross_entropy, lm_loss

    card = chip_smoke.card_line()
    cfg = get_config(chip_smoke.LM_ARCH)
    lm = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(chip_smoke.SEED))
    batch = make_batch_for(cfg, chip_smoke.TRAIN_B, chip_smoke.TRAIN_T)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    _compare_variants(
        f"{chip_smoke.LM_ARCH} {chip_smoke.TRAIN_B} x {chip_smoke.TRAIN_T}, "
        f"remat on", lm, lambda: lm_loss(cfg, lm(batch, train=True), batch,
                                         {})[0],
        chip_smoke.TRAIN_LR, 4, rounds, card)
    del lm
    torch.cuda.empty_cache()

    cnn = build_cnn("efficientnet_b0", **chip_smoke.FQ_OPTS).init_weights(
        torch.Generator(device=dev).manual_seed(0), device=dev)
    x, y = SyntheticImages(noise=0.2).batch(64, 0)
    x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)

    def cnn_loss():
        cnn.train()
        try:
            return cross_entropy(cnn(x), y)
        finally:
            cnn.eval()

    _compare_variants(f"cnn_fakequant oracle efficientnet_b0 "
                      f"{chip_smoke.FQ_OPTS}, batch 64", cnn, cnn_loss, 2e-3,
                      10, rounds, card)


def _compare_variants(label, model, loss_of, peak_lr, n, rounds, card):
    from repro_torch.models.convert import reference_leaves
    from repro_torch.nn.module import trainable
    from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                                   stacked_grads, stacked_params,
                                   warmup_cosine)

    trainable(model)
    leaves = reference_leaves(model)
    lr = warmup_cosine(peak_lr, 1, 1000)      # no step reaches the decay's end
    variants = {
        "multi-tensor": (adamw(lr), clip_by_global_norm, apply_updates),
        "per-leaf": (per_leaf_adamw(lr), per_leaf_clip, per_leaf_apply)}
    state = variants["multi-tensor"][0].init(stacked_params(leaves))

    def step(variant):
        nonlocal state
        opt, clip, apply = variants[variant]
        loss_of().backward()
        grads, _ = clip(stacked_grads(leaves), 1.0)
        with torch.no_grad():
            upd, state = opt.update(grads, state, stacked_params(leaves))
            apply(leaves, upd)

    for v in variants:                                     # warm-up
        step(v)
    loss_of().backward()
    grads = stacked_grads(leaves)
    with torch.no_grad():
        params = stacked_params(leaves)
        ups = {v: opt.update(clip(grads, 1.0)[0], state, params)[0]
               for v, (opt, clip, _) in variants.items()}
        diff = max(float((ups["multi-tensor"][k] - ups["per-leaf"][k]
                          ).abs().max()) for k in grads)
        top = max(float(u.abs().max()) for u in ups["per-leaf"].values())
    del ups, params
    print(f"optimizer variants, {label}: {len(leaves)} leaves; one update "
          f"from the same gradient and state differs by at most {diff:.3e} "
          f"(largest update {top:.3e})")

    def opt_only(variant):
        nonlocal state
        opt, clip, apply = variants[variant]
        with torch.no_grad():
            g, _ = clip(grads, 1.0)
            upd, state = opt.update(g, state, stacked_params(leaves))
            apply(leaves, upd)

    res = collections.defaultdict(lambda: collections.defaultdict(list))
    for _ in range(rounds):
        for v in variants:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(n):
                step(v)
            torch.cuda.synchronize()
            res[v]["step ms"].append(
                round((time.perf_counter() - t) / n * 1e3, 2))
            res[v]["peak GiB"].append(
                round(torch.cuda.max_memory_allocated() / 2 ** 30, 2))
            res[v]["optimizer ms"].append(
                round(chip_smoke.cuda_ms(lambda: opt_only(v), 3), 2))
    for v, metrics in res.items():
        print(f"optimizer variants, {label}, {v}: " + "; ".join(
            f"{name} {vals}" for name, vals in metrics.items())
            + f" (rounds alternate multi-tensor, per-leaf; {n} steps a "
            f"block) [{card}]")


TRAIN_GROUPS = {
    "matrix products (*gemm*)":
        lambda k: "gemm" in k.lower() or "xmma" in k.lower(),
    "elementwise (*elementwise*)": lambda k: "elementwise" in k.lower(),
    "reductions (*reduce*)": lambda k: "reduce" in k.lower(),
    "copies and stacks (*copy*, *cat*)":
        lambda k: "copy" in k.lower() or "cat" in k.lower(),
    "softmax": lambda k: "softmax" in k.lower()}


def _depthwise(k):
    return "depthwise" in k.lower()


def _batchnorm(k):
    return any(t in k.lower() for t in ("bn_fw", "batch_norm"))


# disjoint groups of kernel names (cuDNN's BatchNorm kernels are named
# cudnn::bn_fw_*, PyTorch's depthwise convolution conv_depthwise2d_*)
CNN_GROUPS = {
    "convolutions and Dense GEMMs (implicit GEMM, sgemm)": lambda k: any(
        t in k.lower() for t in ("conv", "xmma", "gemm"))
    and not _depthwise(k) and not _batchnorm(k),
    "depthwise convolutions (conv_depthwise2d)": _depthwise,
    "BatchNorm (cudnn bn_fw)": _batchnorm,
    "elementwise passes (SiLU, sigmoid, products, sums, fake-quant)":
        lambda k: "elementwise" in k.lower(),
    "reductions (pools, min, max)": lambda k: "reduce" in k.lower(),
}


def cnn_profile(dev, front):
    """The accuracy path of ``chip_smoke.py`` under the profiler: the
    monolithic forward, the partitioned fake-quant forward at the widest
    cut vector of ``front``, and the link fake-quant passes alone."""
    from repro_torch.core.graph import linearize
    from repro_torch.core.quant import quantize_tensor
    from repro_torch.models.cnn.zoo import run_blocks
    from repro_torch.serving import PartitionedCNNRunner

    model, _, _, xd, _ = chip_smoke.cnn_setup(dev)
    spec = chip_smoke.main_spec()
    quant_specs = [p.quant for p in spec.system.build().platforms]
    schedule = linearize(model.to_graph(), spec.schedule_policy)
    split, block_cuts, stage_specs = chip_smoke.widest_split(
        model, schedule, [tuple(c) for c in front], quant_specs)
    runner = PartitionedCNNRunner(model, block_cuts, stage_specs)
    with torch.no_grad():
        links = [(run_blocks(model.blocks[:c + 1], xd), s)
                 for c, s in zip(block_cuts, stage_specs)]

    def forward():
        with torch.no_grad():
            model(xd)

    def partitioned():
        runner.run(xd)

    def link_quant():
        for a, s in links:
            quantize_tensor(a, s)

    for fn in (forward, partitioned, link_quant):
        fn()
    torch.cuda.synchronize()
    b = chip_smoke.CNN_BATCH
    profiled(f"efficientnet_b0 forward {b} x 224", forward, groups=CNN_GROUPS)
    profiled(f"efficientnet_b0 partitioned fake-quant forward at {split} "
             f"(blocks {block_cuts}, bits {[s.bits for s in stage_specs]})",
             partitioned, groups=CNN_GROUPS)
    profiled(f"link fake-quant passes alone ({len(links)} links, "
             f"{[tuple(a.shape) for a, _ in links]})", link_quant,
             groups=CNN_GROUPS)



# VGG-16's first classifier layer, and the batches at which the product
# kernel is timed against it: at M 256 the kernel's 128 x 128 tiles make 64
# tiles, split over K into 4 ranges (256 blocks) for the card's 132 SMs
QMM_K, QMM_N, QMM_MS = 25088, 4096, (256, 512, 1024, 2048)
TRACE_ARGS = ("grid", "block", "registers per thread", "shared memory",
              "blocks per SM", "warps per SM", "est. achieved occupancy %")


def qmm_profile(dev=None):
    """The int8 product kernel at VGG-16's fc0: its launches (quantize,
    product) under the profiler with the trace's launch figures, then
    kernel and ``torch._int_mm`` times as M grows, with each M's split over
    K and grid (a time that grows less than M means the card was not full
    at the smaller M)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import quant_matmul

    dev = dev or torch.device("cuda", 0)
    print(chip_smoke.card_line())
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    w_q = torch.randint(-127, 128, (QMM_K, QMM_N), generator=g, device=dev,
                        dtype=torch.int8)
    w_scale = torch.full((QMM_N,), 1e-3, device=dev)
    x = torch.relu(torch.randn((max(QMM_MS), QMM_K), generator=g,
                               device=dev))

    def args(m):
        xm = x[:m]
        return xm, w_q, w_scale, chip_smoke.act_scale(xm)

    a = args(QMM_MS[0])
    quant_matmul.quant_matmul(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):   # the trace may miss the first launch
            quant_matmul.quant_matmul(*a)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    print(f"quant_matmul at ({QMM_MS[0]}, {QMM_K}) x ({QMM_K}, {QMM_N}), "
          f"the launches of two calls in the profiler's trace:")
    for e in events:
        if e.get("cat") == "kernel" and "qmm_" in e.get("name", ""):
            figs = ", ".join(f"{k} {e['args'][k]}" for k in TRACE_ARGS
                             if k in e.get("args", {}))
            print(f"  {e['name'][:60]}: {e['dur']} us; "
                  f"{figs or 'no launch figures in the trace'}")
    print("quant_matmul and torch._int_mm (the product alone, on the same "
          "int8 x) as M grows:")
    base = None
    tile = quant_matmul.TILE
    for m in QMM_MS:
        a = args(m)
        ms = chip_smoke.cuda_ms(lambda: quant_matmul.quant_matmul(*a), 10)
        xq = torch.clamp(torch.round(a[0] / a[3]), -128, 127).to(torch.int8)
        int_mm = chip_smoke.cuda_ms(lambda: torch._int_mm(xq, w_q), 10)
        base = base or ms
        tops = 2 * m * QMM_K * QMM_N / (ms * 1e-3) / 1e12
        splits = quant_matmul.split_count(m, QMM_K, QMM_N,
                                          quant_matmul._sms(dev.index or 0))
        print(f"  M {m}: kernel {ms:.4f} ms ({ms / base:.2f} x M "
              f"{QMM_MS[0]}'s time for {m / QMM_MS[0]:.0f} x the work, "
              f"{tops:.1f} TOP/s; splits {splits}, grid {-(-m // tile)} x "
              f"{-(-QMM_N // tile)} x {splits}), _int_mm {int_mm:.4f} ms")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
