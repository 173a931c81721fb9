"""Checkpoints: step snapshots plus a rolling latest, and the import of the
reference's `.pth` checkpoints (counterpart of
`cvpr23_lfdm_tpu/utils/checkpoint.py`).

:class:`CheckpointManager` keeps the JAX class's layout and methods with
`torch.save` files in place of Orbax directories: `<dir>/step_<N:08d>.pt`
snapshots (the newest `max_to_keep` kept) and a rolling `<dir>/latest.pt`,
each with an optional JSON sidecar `<name>.extra.json` in the JAX package's
format (bytes values base64-encoded). Every file is written to a temporary
name and moved into place with `os.replace`, so a crash mid-write leaves the
previous file whole. A state is a (nested) dict of tensors, numbers and the
containers an optimizer's `state_dict` holds; tensors are saved from the
CPU, and `restore` reads them back with `weights_only=True` onto the device
it is given.

`load_torch_state_dicts`, `load_lfae_from_torch` and `load_unet_from_torch`
read the reference's released checkpoints (`RegionMM.pth`, `flowdiff.pth`)
into the port's modules through `utils/torch_convert.py`. No such file is in
the repository.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os

import torch

from cvpr23_lfdm_torch.utils.torch_convert import convert_lfae_checkpoint, convert_unet3d


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    """Snapshots `<dir>/step_<N:08d>.pt` + rolling `<dir>/latest.pt`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _write_state(self, name: str, state) -> str:
        path = self._path(f"{name}.pt")
        tmp = self._path(f".{name}.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def save(self, state, step: int | None = None, rolling: bool = True,
             extra: dict | None = None) -> str:
        """Save a snapshot; with `rolling`, also refresh `latest`. Returns
        the path of the last file written.

        `extra` is a small JSON-serializable sidecar (host-side resume
        state: data-loader position, host RNG seed, ...) written atomically
        next to the state as `<name>.extra.json`; bytes values are
        base64-encoded."""
        if step is None and not rolling:
            raise ValueError("save() needs a step, rolling=True, or both")
        state = _to_cpu(state)
        if step is not None:
            name = f"step_{int(step):08d}"
            path = self._write_state(name, state)
            if extra is not None:
                self._write_extra(name, extra)
            self._gc()
        if rolling:
            path = self._write_state("latest", state)
            if extra is not None:
                self._write_extra("latest", extra)
        return path

    def _write_extra(self, name: str, extra: dict) -> None:
        def enc(v):
            if isinstance(v, bytes):
                return {"__bytes_b64__": base64.b64encode(v).decode("ascii")}
            return v

        tmp = self._path(f".{name}.extra.json.tmp")
        with open(tmp, "w") as f:
            json.dump({k: enc(v) for k, v in extra.items()}, f)
        os.replace(tmp, self._path(f"{name}.extra.json"))

    def load_extra(self, name: str = "latest") -> dict | None:
        """Sidecar saved alongside `name`, or None if absent."""
        path = self._path(f"{name}.extra.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            raw = json.load(f)

        def dec(v):
            if isinstance(v, dict) and "__bytes_b64__" in v:
                return base64.b64decode(v["__bytes_b64__"])
            return v

        return {k: dec(v) for k, v in raw.items()}

    def restore(self, name: str = "latest", map_location=None):
        """The state saved as `name` (`latest` or `step_<N:08d>`), its
        tensors on `map_location` (e.g. the trainer's device; None: the
        CPU)."""
        return torch.load(self._path(f"{name}.pt"), map_location=map_location or "cpu",
                          weights_only=True)

    def _steps(self) -> list[str]:
        return sorted(d[:-3] for d in os.listdir(self.directory)
                      if d.startswith("step_") and d.endswith(".pt"))

    def latest_step(self) -> int | None:
        steps = [int(d.split("_")[1]) for d in self._steps()]
        return max(steps) if steps else None

    def has_latest(self) -> bool:
        return os.path.isfile(self._path("latest.pt"))

    def _gc(self) -> None:
        for name in self._steps()[: -self.max_to_keep]:
            for suffix in (".pt", ".extra.json"):
                with contextlib.suppress(OSError):
                    os.remove(self._path(name + suffix))


def load_torch_state_dicts(path: str) -> dict:
    """A reference `.pth` checkpoint as CPU tensors: every state dict it
    holds (`{name: tensor}`) and its numbers; the optimizer state is dropped.

    Handles the LFAE layout {generator, region_predictor, bg_predictor,
    optimizer, epoch, example} (LFAE/train.py:134-142) and the DM layout
    {diffusion, optimizer_diff, example} (DM train :365-369). Read with
    `weights_only=True`: those layouts hold only tensors, numbers and
    optimizer dicts."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for key, value in ckpt.items():
        if isinstance(value, dict) and value and all(torch.is_tensor(v) for v in value.values()):
            out[key] = dict(value)
        elif isinstance(value, (int, float)):
            out[key] = value
    return out


def load_lfae_from_torch(path: str, lfae_cfg) -> dict[str, torch.Tensor]:
    """Reference `RegionMM.pth` -> a state dict of `FlowAE(lfae_cfg)` (and of
    `LFAEReconstruction`)."""
    return convert_lfae_checkpoint(load_torch_state_dicts(path), lfae_cfg)


def load_unet_from_torch(path: str, unet) -> dict[str, torch.Tensor]:
    """Reference `flowdiff.pth` -> a state dict of `unet` (a `Unet3D` built
    from the run's config). The reference prefixes the UNet's parameters with
    `denoise_fn.` inside its diffusion wrapper."""
    sd = load_torch_state_dicts(path)["diffusion"]
    unet_sd = {k[len("denoise_fn."):]: v for k, v in sd.items() if k.startswith("denoise_fn.")}
    return convert_unet3d(unet_sd, unet)
