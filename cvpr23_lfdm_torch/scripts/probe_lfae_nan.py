"""Where an LFAE training run first gets a non-finite gradient.

`LFAETrainer.train_step` at the MUG config's full widths (fp32, TF32 off)
from seeded weights (`seed_lfae_weights(--seed)`, `seed_vgg_weights(--seed)`)
on a seeded uniform batch (`--data-seed`, `--batch` frame pairs), each step
drawing its TPS transform from `step_generator(0, step)`. Per step: the
losses and the parameters whose gradient is not finite; the run stops at
the first such step. With `--anomaly`, that step runs again under
`torch.autograd.detect_anomaly` and the line names the backward function
that made the first NaN and the forward line that built it.

A thin region heatmap (a softmax at temperature 0.1 that puts its mass on
one row or column of pixels) has a covariance whose smaller eigenvalue the
JAX package's fp32 closed form `tr / 2 - rad` rounds to 0, and its
`sqrt_psd_2x2` then differentiates `sqrt` at 0. The port takes that
eigenvalue as `det / s1` (`ops/eig2x2.py`), which does not cancel; the
probe finds where a run still goes non-finite.

Usage: python -m cvpr23_lfdm_torch.scripts.probe_lfae_nan [--seed 2]
       [--data-seed 3] [--batch 16] [--steps 3] [--anomaly] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import warnings

import numpy as np
import torch

from cvpr23_lfdm_torch.config import mug_config
from cvpr23_lfdm_torch.scripts._common import add_device_arg, card_line, emit
from cvpr23_lfdm_torch.train.dm_trainer import step_generator
from cvpr23_lfdm_torch.train.lfae_trainer import LFAETrainer
from cvpr23_lfdm_torch.utils.device import resolve_device


def non_finite_grads(model) -> list[str]:
    return [n for n, p in model.named_parameters()
            if p.grad is not None and not bool(torch.isfinite(p.grad).all())]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--data-seed", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--anomaly", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mug_config()
    trainer = LFAETrainer(cfg, steps_per_epoch=93, device=device, vgg_seed=args.seed)
    state = trainer.init_state(seed=args.seed)
    rng = np.random.RandomState(args.data_seed)
    s = cfg.lfae.frame_shape
    batch = {k: torch.from_numpy(rng.uniform(size=(args.batch, s, s, 3)).astype(np.float32)).to(device)
             for k in ("source", "driving")}
    line = {"seed": args.seed, "data_seed": args.data_seed, "batch": args.batch, "steps": []}
    for i in range(args.steps):
        snapshot = copy.deepcopy(trainer.state_dict(state)) if args.anomaly else None
        state, m = trainer.train_step(state, step_generator(0, i, device), batch)
        bad = non_finite_grads(trainer.model)
        line["steps"].append({"step": i, "losses": {k: float(v) for k, v in m.items()},
                              "non_finite_grads": len(bad), "first": bad[:4]})
        if bad:
            if args.anomaly:
                again = trainer.load_state_dict(snapshot)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    try:
                        with torch.autograd.detect_anomaly(check_nan=True):
                            trainer.train_step(again, step_generator(0, i, device), batch)
                    except RuntimeError as e:
                        line["anomaly"] = str(e)
                forward = [str(w.message) for w in caught if "Traceback of forward call" in str(w.message)]
                line["forward_tail"] = forward[-1].splitlines()[-9:-1] if forward else None
            break
    emit({**line, "card": card_line(device)})


if __name__ == "__main__":
    main()
