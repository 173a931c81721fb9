"""Synthetic frames made on the device from the seed: smooth videos of
three coloured gaussian blobs moving over a flat background, stored as
uint8 `[V, T, S, S, 3]` (the shape of a frame-folder corpus)."""

from __future__ import annotations

import torch

from portbench.harness.weights import generator


def blob_videos(seed: int, tag: str, videos: int, frames: int, size: int, device,
                blobs: int = 3, chunk: int = 8) -> torch.Tensor:
    g = generator(seed, "frames", tag, device=device)
    u = lambda *shape: torch.rand(*shape, generator=g, device=device)  # noqa: E731
    start = 0.2 + 0.6 * u(videos, blobs, 2)
    velocity = (u(videos, blobs, 2) - 0.5) * 0.6
    sigma = 0.08 + 0.07 * u(videos, blobs, 1)
    colour = 0.2 + 0.8 * u(videos, blobs, 3)
    background = 0.3 * u(videos, 1, 1, 1, 3)
    coord = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    t = torch.arange(frames, device=device, dtype=torch.float32) / max(frames - 1, 1)
    out = torch.empty((videos, frames, size, size, 3), dtype=torch.uint8, device=device)
    for v0 in range(0, videos, chunk):
        v = slice(v0, min(v0 + chunk, videos))
        centre = start[v, None] + velocity[v, None] * t[None, :, None, None]  # [v, T, K, 2]
        s2 = 2 * sigma[v, None] ** 2  # [v, 1, K, 1]
        gx = torch.exp(-(coord - centre[..., 0:1]) ** 2 / s2)  # [v, T, K, S]
        gy = torch.exp(-(coord - centre[..., 1:2]) ** 2 / s2)
        img = torch.einsum("vtky,vtkx,vkc->vtyxc", gy, gx, colour[v]) + background[v]
        out[v] = (img.clamp(0, 1) * 255).round().to(torch.uint8)
    return out
