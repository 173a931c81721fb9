"""Shared pieces of the port's scripts.

The CLIs (`demo`, `test_dm`, `eval_flowautoenc`, `train_dm`,
`train_lfae`, `make_bench_ckpt`, `preprocess`; counterpart of
`scripts/_common.py`): :func:`base_parser` with `--device` in place of
the JAX `--platform` / `--matmul-precision`, :func:`check_unported`,
:func:`resolve_attn_impl`, :func:`apply_lfae_dtype`,
:func:`resolve_data_root`, :func:`load_text_embedder`, the weight
loaders, and the training CLIs' resumable loader (:func:`train_loader`,
:func:`loader_extra`). The JAX parser's `--warp-impl` has no counterpart:
the port has one exact decode warp at every scale.

The bench scripts: the `--device` flag, the repository's bench
checkpoint, the two fused layers' serving shapes and their one bench
(`run_layer`), one JSON object per output line."""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
from typing import Callable, NamedTuple

import torch


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_CKPT = os.path.join(ROOT, "assets", "bench_ckpt")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (C, HW) of the temporal layer's calls in one `pallas3` UNet eval of the MUG
# config (B=1, F=40, 8 heads of 32) and their count per eval
TEMPORAL_SHAPES = {(64, 1024): 3, (128, 256): 1, (64, 256): 1, (256, 64): 1,
                   (128, 64): 1, (512, 16): 2, (256, 16): 1}
# the same for the linear-attention layer's calls
LINEAR_SHAPES = {(64, 1024): 2, (128, 256): 1, (256, 64): 1, (512, 16): 1,
                 (256, 16): 1, (128, 64): 1, (64, 256): 1}
F, HEADS, D = 40, 8, 32  # frames, heads and channels per head of those calls
DDIM_STEPS = 10  # UNet evals per serving video


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises when there is none); "
                         "'cpu' rehearses the script on the kernels' plain versions")


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` prints them, or
    `cpu` for a CPU rehearsal."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def layer_inputs(c: int, hw: int, device, seed: int = 0):
    """Seeded inputs that both fused layers take, at `[1, F, HW, C]`: x,
    W_qkv and W_out in bf16, gamma in fp32; and the generator, for the
    layer's own inputs after them."""
    g = torch.Generator().manual_seed(seed)
    hd = HEADS * D
    to = lambda t, dt=torch.bfloat16: t.to(device=device, dtype=dt)
    x = to(torch.randn(1, F, hw, c, generator=g))
    gamma = to(1 + 0.1 * torch.randn(c, generator=g), torch.float32)
    wqkv = to(torch.randn(c, 3 * hd, generator=g) * c ** -0.5)
    wout = to(torch.randn(hd, c, generator=g) * hd ** -0.5)
    return g, (x, gamma, wqkv, wout)


class LayerBench(NamedTuple):
    """One fused layer's bench (`run_layer`): its function and plain
    version, `make_args(c, hw, device)`, its serving shapes {(C, HW): calls
    per eval}, its device launches per call, the name of its plan in
    `ops.attention`, `scan(hw)` -> {label: keyword arguments of the plan}
    (the plans `--scan` forces), and the parts of its kernels' names whose
    device time is read apart (`by`)."""
    name: str
    fn: Callable
    plain: Callable
    make_args: Callable
    shapes: dict
    launches: int
    plan: str
    scan: Callable
    by: tuple = ()


def run_layer(layer: LayerBench, scan: bool = False) -> list:
    """Lines of one layer's reading, bf16 on the card: one per serving shape
    (device ms per call from torch.profiler over 10 calls, and per launch
    with `layer.by`; call ms by CUDA events around the function, its host
    work included; with `scan` the device time and max abs error against
    the plain layer under each plan `layer.scan` forces), then the sum of
    the device times over one serving video. Uses only the layer's public
    function and plan, so it can time another checkout of the package."""
    from cvpr23_lfdm_torch.ops import attention as attn_ops
    from cvpr23_lfdm_torch.utils.profiling import device_ms, time_fn

    if not torch.cuda.is_available():
        raise RuntimeError(f"{layer.name}: the bench reads device time; needs the card")

    def reading(call) -> dict:
        ms = device_ms(call, launches=layer.launches, by=layer.by)
        if ms is None:
            raise RuntimeError(f"{layer.name}: the profiler lost kernels; read again")
        if not layer.by:
            return {"device_ms": ms}
        return {"device_ms": ms["total"], "device_ms_by_launch": {k: ms[k] for k in layer.by}}

    lines, per_video = [], 0.0
    with torch.no_grad():
        for (c, hw), n_eval in layer.shapes.items():
            args = layer.make_args(c, hw, "cuda")
            call = lambda: layer.fn(*args)
            line = {"shape": [1, F, hw, c], "calls_per_video": n_eval * DDIM_STEPS,
                    **reading(call), "call_ms": time_fn(call)["median_ms"]}
            per_video += n_eval * DDIM_STEPS * line["device_ms"]
            if scan:
                ref = layer.plain(*args).float()
                saved = getattr(attn_ops, layer.plan)
                line["plan_scan"] = {}
                for label, kwargs in layer.scan(hw).items():
                    setattr(attn_ops, layer.plan, functools.partial(saved, **kwargs))
                    try:
                        err = float((call().float() - ref).abs().max())
                        line["plan_scan"][label] = {**reading(call), "max_abs_err": err}
                    except (RuntimeError, ValueError) as e:
                        line["plan_scan"][label] = str(e)[:80]
                    finally:
                        setattr(attn_ops, layer.plan, saved)
            lines.append(line)
    lines.append({"device_ms_per_video": per_video,
                  "calls_per_video": sum(layer.shapes.values()) * DDIM_STEPS})
    return lines


def layer_main(layer: LayerBench, doc: str) -> None:
    """Command line of a layer bench: `[--scan]`, card only."""
    from cvpr23_lfdm_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--scan", action="store_true", help="also every plan the layer's scan forces")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError(f"{layer.name}: the bench reads device time; needs the card")
    card = card_line(device)
    for line in run_layer(layer, args.scan):
        emit({**line, "dtype": "bfloat16", "card": card})


# ------------------------------------------------------------------- CLIs

def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags every CLI takes, with the JAX CLIs' names and defaults."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset", default="mug", choices=["mug", "mhad", "natops"])
    p.add_argument("--data-root", default="", help="frame-folder corpus root")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic corpus under --data-root (or a tmp dir)")
    p.add_argument("--log-dir", default="log")
    p.add_argument("--seed", type=int, default=1234)
    add_device_arg(p)
    p.add_argument("--bert-path", default="bert-base-cased",
                   help="LOCAL directory of the bert-base-cased checkpoint (config.json, "
                        "vocab.txt, model.safetensors or pytorch_model.bin) to build the "
                        "class-text table when assets/bert_<dataset>.npz is missing")
    p.add_argument("--allow-random-text", action="store_true",
                   help="permit a deterministic RANDOM class-embedding table when no BERT "
                        "table can be built (smoke/ablation only; conditioning values will "
                        "NOT match the reference). Implied by --synthetic.")
    p.add_argument("--loader", default="threads", choices=["threads", "grain"],
                   help="batch loader backend of the training CLIs: the thread pool, or worker "
                        "PROCESSES (data/grain_loader.py, on torch.utils.data; resumable mid-epoch)")
    p.add_argument("--attn-impl", default="auto", choices=["auto", "xla", "pallas3", "pallas2", "pallas"],
                   help="UNet form: auto = pallas3 (the fused layers, rows 1 and 2) for "
                        "serving, pallas2 for training; a named form is built as named")
    p.add_argument("--lfae-dtype", default="", choices=["", "float32", "bfloat16"],
                   help="LFAE compute dtype override (default: the preset's float32)")
    p.add_argument("--coordinator", default="", help="multi-host: not ported")
    p.add_argument("--num-processes", type=int, default=0, help="multi-host: not ported")
    p.add_argument("--mesh", default="", help="multi-device serving mesh: not ported")
    p.add_argument("--process-id", type=int, default=-1, help="multi-host: not ported")
    return p


def check_unported(args) -> None:
    """A flag whose machinery is not ported raises, never silently ignored."""
    if args.mesh or args.coordinator or args.num_processes > 1 or args.process_id >= 0:
        raise SystemExit("--mesh / --coordinator / --num-processes / --process-id: multi-device "
                         "is not ported yet (ROADMAP item 6)")


def setup(args) -> torch.device:
    """Check the flags; the device the run takes (`--device`, else the card)."""
    from cvpr23_lfdm_torch.utils.device import resolve_device

    check_unported(args)
    return resolve_device(args.device)


def resolve_attn_impl(args, training: bool = False) -> str:
    """`--attn-impl` -> the UNet form (`models/unet3d.py::resolve_attn_impl`)."""
    from cvpr23_lfdm_torch.models.unet3d import resolve_attn_impl as resolve

    return resolve(args.attn_impl, training)


def apply_lfae_dtype(cfg, args):
    """Apply `--lfae-dtype` to a full config (empty: the preset's float32)."""
    if getattr(args, "lfae_dtype", ""):
        import dataclasses

        cfg = cfg.replace(lfae=dataclasses.replace(cfg.lfae, compute_dtype=args.lfae_dtype))
    return cfg


def resolve_data_root(args, image_size: int = 128) -> str:
    """`--data-root`, or with `--synthetic` a synthetic corpus there (or in a
    new temporary directory) covering both splits."""
    from cvpr23_lfdm_torch.data.specs import get_spec
    from cvpr23_lfdm_torch.data.synthetic import make_synthetic_corpus

    root = args.data_root
    if args.synthetic:
        if not root:
            import tempfile

            root = tempfile.mkdtemp(prefix=f"{args.dataset}_synth_")
        if not os.path.isdir(root) or not os.listdir(root):
            os.makedirs(root, exist_ok=True)
            size = max(image_size, 320 if args.dataset == "natops" else image_size)
            spec = get_spec(args.dataset)
            subjects = list(spec.train_subjects[:2]) + list(spec.test_subjects[:2])
            make_synthetic_corpus(root, args.dataset, num_frames=16, size=size, seed=args.seed,
                                  subjects=subjects, classes=None, takes=2)
        print(f"synthetic corpus at {root}")
    if not root:
        raise SystemExit("--data-root required (or pass --synthetic)")
    return root


def load_text_embedder(dataset_or_args, allow_random: bool = False, device=None):
    """The cached BERT class-text table, built from `--bert-path` when the
    cache is missing. Without a cache and a checkpoint this is a HARD error
    unless `--allow-random-text` (or `--synthetic`): a random table gives
    conditioning values that cannot match the reference."""
    from cvpr23_lfdm_torch.models.text import DATASET_CLASSES, TextEmbedder

    if isinstance(dataset_or_args, str):  # tests / direct calls
        dataset, bert_path = dataset_or_args, "bert-base-cased"
    else:
        args = dataset_or_args
        dataset, bert_path, device = args.dataset, args.bert_path, args.device
        allow_random = args.allow_random_text or args.synthetic
    try:
        return TextEmbedder.build(dataset, model_name_or_path=bert_path, device=device)
    except (OSError, KeyError, ValueError) as e:  # no cache and no readable checkpoint
        if not allow_random:
            raise SystemExit(
                f"BERT class embeddings unavailable ({e}).\n"
                f"Provide --bert-path <dir> with a local bert-base-cased checkpoint "
                f"(config.json + model.safetensors/pytorch_model.bin + vocab.txt), or pass "
                f"--allow-random-text to proceed with a deterministic random table "
                f"(smoke/ablation only).") from None
        print(f"warning: BERT embeddings unavailable ({e}); using random table")
        return TextEmbedder.random_for_testing(DATASET_CLASSES[dataset])


def lfae_state(path: str, lfae_cfg) -> dict | None:
    """The `FlowAE` state dict of `--lfae-ckpt`: a reference `.pth`, or a
    port checkpoint directory (`CheckpointManager`, the LFAE trainer's
    `state_dict`); None for an empty path."""
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager, load_lfae_from_torch

    if not path:
        return None
    if path.endswith(".pth"):
        return load_lfae_from_torch(path, lfae_cfg)
    return CheckpointManager(path).restore("latest")["model"]


def unet_state(path: str, unet) -> dict | None:
    """The UNet state dict of `--dm-ckpt`: a reference `.pth`, or a port
    checkpoint directory (the DM trainer's `state_dict`); None for an empty
    path."""
    from cvpr23_lfdm_torch.utils.checkpoint import CheckpointManager, load_unet_from_torch

    if not path:
        return None
    if path.endswith(".pth"):
        return load_unet_from_torch(path, unet)
    return CheckpointManager(path).restore("latest")["unet"]


def load_model_weights(model, lfae_path: str, dm_path: str) -> None:
    """Load `--lfae-ckpt` / `--dm-ckpt` into a `FlowDiffusion`; what is not
    given gets seeded weights (`seed_lfae_weights`, seeds 0 and 1), with a
    warning, as the JAX CLIs' random init."""
    from cvpr23_lfdm_torch.models.flow_autoenc import seed_lfae_weights

    lfae = [getattr(model, n) for n in ("region_predictor", "bg_predictor", "generator")
            if hasattr(model, n)]
    state = lfae_state(lfae_path, model.lfae_cfg)
    if state is None:
        print("warning: no --lfae-ckpt; RANDOM stage-1 weights (smoke mode)")
        seed_lfae_weights(lfae, 0)
    else:
        for name in ("region_predictor", "bg_predictor", "generator"):
            if hasattr(model, name):
                module = getattr(model, name)
                own = module.state_dict()
                module.load_state_dict({k: state[f"{name}.{k}"] for k in own})
    state = unet_state(dm_path, model.unet)
    if state is None:
        print("warning: no --dm-ckpt; RANDOM UNet weights (smoke mode)")
        seed_lfae_weights([model.unet], 1)
    else:
        model.unet.load_state_dict(state)


def train_loader(args, dataset, batch_size: int, start_step: int, ckpt, threads: int):
    """The training CLIs' batch loader, at the batch a resumed run starts
    from: `--loader threads` seeks `PrefetchLoader` to `start_step` (its
    stream is a pure function of the batch number); `--loader grain` seeks
    `GrainLoader` (8 worker processes) to the state saved in the
    checkpoint's sidecar. One process: the whole global batch."""
    from cvpr23_lfdm_torch.data import PrefetchLoader
    from cvpr23_lfdm_torch.data.grain_loader import GrainLoader

    if args.loader != "grain":
        return PrefetchLoader(dataset, batch_size, num_workers=threads, seed=args.seed,
                              start_batch=start_step)
    loader = GrainLoader(dataset, batch_size, num_workers=8, seed=args.seed)
    extra = ckpt.load_extra() if start_step else None
    if extra and "grain_state" in extra:
        loader.set_state(extra["grain_state"])
    return loader


def loader_extra(args, loader) -> dict:
    """The checkpoint sidecar of a training CLI: the seed, and the
    `--loader grain` position."""
    extra = {"seed": args.seed}
    if args.loader == "grain":
        extra["grain_state"] = loader.get_state()
    return extra
