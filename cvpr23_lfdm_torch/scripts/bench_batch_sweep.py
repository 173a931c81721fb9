"""Serving batch-size sweep: per-call and pipelined frames/s for B in a list.

Counterpart of the JAX package's `scripts/bench_batch_sweep.py`. Runs the
serving graph, `FlowDiffusion.sample_video` at the MUG config (DDIM-10, bf16
UNet and LFAE, `pallas3`: rows 1 and 2 in the UNet, row 3 in the decode) on
the bench checkpoint's weights, its reference frame and class vector
broadcast over the batch, at each batch size, and reports

  * per-call fps:  one call, then `torch.cuda.synchronize()`, median of
    `--iters` calls after two warm-ups;
  * pipelined fps: `--pipe-depth` calls enqueued back to back, one sync at
    the end;
  * peak allocated memory of one call, the kernel launches of one call, and
    whether its outputs are finite with `out_vid` in [0, 1].

Pipelining means something only if a call never waits for the card. Before
the sweep, one pipelined run goes under `torch.cuda.set_sync_debug_mode`:
first "warn", which lists every place (file:line of the port) that
synchronises the host with the card, then, if there is none, "error", which
would raise at the first. The summary line says whether the sweep is
pipelined (`host_syncs` empty) and names the best batch, as the JAX script's.

With `--device cpu` (a rehearsal on the kernels' plain versions) the clock
is the host's and the sync check does not apply. `--bench-ckpt ''` runs on
seeded weights (the JAX script's "random").

Usage: python -m cvpr23_lfdm_torch.scripts.bench_batch_sweep [--batches 1 2 4 8 16]
           [--iters 6] [--pipe-depth 6] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import traceback
import warnings

import numpy as np
import torch

from cvpr23_lfdm_torch.scripts._common import BENCH_CKPT, add_device_arg, card_line, emit

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0  # the sampler's draws, and the weights, frame and vector without a checkpoint


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8, 16])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--pipe-depth", type=int, default=6)
    ap.add_argument("--bench-ckpt", default=BENCH_CKPT,
                    help="bench checkpoint directory ('' or absent: seeded weights)")
    add_device_arg(ap)
    return ap


def serving_config(cfg):
    """The sweep's form of a config: DDIM-10, `pallas3`, bf16 UNet and LFAE."""
    return cfg.replace(
        diffusion=dataclasses.replace(cfg.diffusion, sampling_timesteps=10, compute_dtype="bfloat16",
                                      temporal_attn_impl="pallas3"),
        lfae=dataclasses.replace(cfg.lfae, compute_dtype="bfloat16"))


def serving_model(cfg, ckpt: str, device):
    """`(cfg, model, cond [1, D], ref [1, H, W, 3], weights)`: the bench
    checkpoint (its objective, reference frame and class vector) when
    `ckpt` is a directory, else seeded weights, a seeded frame and vector."""
    from cvpr23_lfdm_torch.diffusion.flow_diffusion import FlowDiffusion
    from cvpr23_lfdm_torch.models.flow_autoenc import seed_lfae_weights
    from cvpr23_lfdm_torch.utils.bench_ckpt import apply_bench_ckpt

    cfg = serving_config(cfg)
    g = torch.Generator().manual_seed(SEED)
    s = cfg.lfae.frame_shape
    if ckpt and os.path.isdir(ckpt):
        cfg, model, cond, ref, _ = apply_bench_ckpt(ckpt, cfg, device=device)
        weights = "trained-synthetic"
    else:
        model = FlowDiffusion(cfg.lfae, cfg.diffusion, device=device)
        seed_lfae_weights([model.generator, model.unet], SEED)
        cond, ref, weights = torch.randn(1, cfg.diffusion.cond_dim, generator=g).to(device), None, "random"
    if ref is None:
        ref = torch.rand(1, s, s, 3, generator=g).to(device)
    return cfg, model, cond, ref, weights


def host_syncs(fn) -> list:
    """Where `fn()` synchronises the host with the card: for each sync that
    torch's sync debug mode reports, the port's two innermost `file:line`
    on the stack, the innermost function and the message, deduplicated.
    Empty on a CPU run."""
    if not torch.cuda.is_available():
        return []
    found = []
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):  # shown as usual
            show(message, category, filename, lineno, file, line)
            return
        stack = [fr for fr in traceback.extract_stack()[:-1] if not fr.filename.endswith("warnings.py")]
        ours = [fr for fr in stack if fr.filename.startswith(PKG)]
        where = [f"{os.path.relpath(fr.filename, os.path.dirname(PKG))}:{fr.lineno}" for fr in ours[-2:]]
        last = stack[-1]
        found.append(" < ".join(reversed(where)) + f" (in {os.path.basename(last.filename)}:{last.lineno} "
                     f"{last.name}: {str(message)[:60]})")

    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(before)
    torch.cuda.synchronize()
    return sorted(set(found))


def raises_on_sync(fn) -> str | None:
    """`fn()` under sync debug mode "error": None if it ran through, else
    the error's message."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return str(e)[:200]
    finally:
        torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()
    return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, args) -> list:
    """The sweep's records: one per batch size, then the summary."""
    from cvpr23_lfdm_torch.ops import read_counters, reset_counters
    from cvpr23_lfdm_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg, model, cond1, ref1, weights = serving_model(cfg, args.bench_ckpt, device)
    frames = cfg.diffusion.num_frames
    card = card_line(device)
    print(f"weights: {weights}", flush=True)

    def requests(b):
        return ref1.expand(b, *ref1.shape[1:]).contiguous(), cond1.expand(b, -1).contiguous()

    def calls(b, n, gen):
        ref, cond = requests(b)
        return [model.sample_video(ref, cond, 1.0, generator=gen) for _ in range(n)]

    b0 = args.batches[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    calls(b0, 1, gen)  # warm-up: kernel builds, cuDNN plans
    _sync(device)
    syncs = host_syncs(lambda: calls(b0, args.pipe_depth, gen))
    error = None if syncs or not on_card else raises_on_sync(lambda: calls(b0, args.pipe_depth, gen))
    pipelined = on_card and not syncs and error is None
    records, results = [], {}
    for b in args.batches:
        gen = torch.Generator(device=device).manual_seed(SEED)
        calls(b, 2, gen)
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        reset_counters()
        out = calls(b, 1, gen)[0]
        _sync(device)
        launches = read_counters()
        ov = out["out_vid"]
        checks = {"finite": all(bool(torch.isfinite(v.float()).all()) for v in out.values()),
                  "out_vid_in_unit_range": bool((ov >= 0).all() and (ov <= 1).all()),
                  "out_vid_shape": list(ov.shape)}
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None
        del out, ov
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            calls(b, 1, gen)
            _sync(device)
            ts.append(time.perf_counter() - t0)
        percall = b * frames / float(np.median(ts))
        _sync(device)
        t0 = time.perf_counter()
        outs = calls(b, args.pipe_depth, gen)
        _sync(device)
        piped = args.pipe_depth * b * frames / (time.perf_counter() - t0)
        del outs
        results[b] = {"percall_fps": percall, "pipelined_fps": piped}
        rec = {"batch": b, "weights": weights, **results[b], "percall_s": ts,
               "peak_mem_gb": peak, "launches_per_call": launches, **checks,
               "pipelined": pipelined, "clock": "cuda_sync" if on_card else "host", "card": card}
        records.append(rec)
        emit(rec)
        if on_card:
            torch.cuda.empty_cache()
    best = max(((b, mode, r[mode]) for b, r in results.items()
                for mode in ("percall_fps", "pipelined_fps")), key=lambda x: x[2])
    summary = {"summary": "batch_sweep", "weights": weights,
               "winner": {"batch": best[0], "mode": best[1], "fps": best[2]}, "sweep": results,
               "pipelined": pipelined, "host_syncs": syncs, "sync_error": error, "card": card}
    records.append(summary)
    emit(summary)
    return records


def main(argv=None) -> list:
    from cvpr23_lfdm_torch.config import mug_config

    args = parser().parse_args(argv)
    return run(mug_config(), args)


if __name__ == "__main__":
    main()
