"""The one traffic generator: synthetic microscopy frames from a traffic
mix's parameters and a seed, made on the device in a few large calls.

A frame is a noisy background with bright ellipses (the cells).  Each
ellipse has an integer centre at least ``MARGIN`` px from the border and
integer radii in ``radius`` (inclusive) and is drawn in its own window,
one pixel wider than the largest radius on each side, so the cost follows
the number of ellipses, not the frame.  Per pixel: ``background + foreground * inside + noise * N(0, 1)``,
clipped to uint16.  For training the same ellipses give the labels: the
cell distance field is a cone (1 at each centre, 0 at the rim, the maximum
where ellipses overlap) and the border field a ring just inside each rim.

Every seed draws the same multiset of ellipse counts, the frames' counts
spread evenly over ``objects`` (inclusive), in an order of its own, so
seeds change the inputs and not the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.common import sub_seed

MARGIN = 10   # px between an ellipse's centre and the frame's border


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def object_counts(mix: dict, n_frames: int, g: torch.Generator) -> np.ndarray:
    lo, hi = mix["objects"]
    counts = np.rint(np.linspace(lo, hi, n_frames)).astype(np.int64)
    order = torch.randperm(n_frames, generator=g, device=g.device).cpu()
    return counts[order.numpy()]


def _ellipses(mix: dict, counts: np.ndarray, size: int,
              g: torch.Generator):
    """(frame index, cy, cx, ry, rx) of every ellipse, int64 tensors on the
    generator's device."""
    dev = g.device
    n = int(counts.sum())
    frame = torch.repeat_interleave(
        torch.arange(len(counts), device=dev),
        torch.as_tensor(counts, device=dev))
    m = MARGIN
    cy = torch.randint(m, size - m, (n,), generator=g, device=dev)
    cx = torch.randint(m, size - m, (n,), generator=g, device=dev)
    r0, r1 = mix["radius"]
    ry = torch.randint(r0, r1 + 1, (n,), generator=g, device=dev)
    rx = torch.randint(r0, r1 + 1, (n,), generator=g, device=dev)
    return frame, cy, cx, ry, rx


def _rasterise(ell, n_frames: int, size: int, window: int, fields: bool):
    """Scatter the ellipses into (n, size, size) planes: inside (0/1) and,
    with ``fields``, the cone and the ring."""
    frame, cy, cx, ry, rx = ell
    dev = cy.device
    d = torch.arange(-window, window + 1, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    dy, dx = dy.reshape(1, -1), dx.reshape(1, -1)
    y, x = cy[:, None] + dy, cx[:, None] + dx
    r = torch.sqrt((dy / ry[:, None].float()) ** 2
                   + (dx / rx[:, None].float()) ** 2)
    flat = (frame[:, None] * size + y) * size + x
    out = {}
    planes = {"inside": (r <= 1.0).float()}
    if fields:
        planes["cell"] = torch.clamp(1.0 - r, min=0.0)
        planes["border"] = torch.where(r <= 1.0, torch.clamp(
            1.0 - torch.abs(r - 0.8) / 0.2, min=0.0), 0.0)
    for k, v in planes.items():
        plane = torch.zeros(n_frames * size * size, device=dev)
        plane.scatter_reduce_(0, flat.reshape(-1), v.reshape(-1), "amax")
        out[k] = plane.view(n_frames, size, size)
    return out


def frames(mix: dict, seed: int, n_frames: int, device,
           stream: int = 1, fields: bool = False, chunk_px: int = 1 << 25):
    """(n_frames, size, size) frames and, with ``fields``, the float32
    label planes on ``device``; without ``fields`` the frames come back as
    a host uint16 array.  Made in chunks of at most ``chunk_px`` pixels."""
    size = mix["frame"]
    g = generator(seed, stream, device)
    counts = object_counts(mix, n_frames, g)
    it = mix["intensity"]
    step = max(1, chunk_px // (size * size))
    imgs, planes_out = [], []
    for s in range(0, n_frames, step):
        c = counts[s:s + step]
        planes = _rasterise(_ellipses(mix, c, size, g), len(c), size,
                            mix["radius"][1] + 1, fields)
        noise = torch.randn((len(c), size, size), generator=g, device=device)
        img = (it["background"] + it["foreground"] * planes.pop("inside")
               + it["noise"] * noise)
        img = torch.clamp(torch.round(img), 0, 65535).to(torch.int32)
        if fields:
            imgs.append(img)
            planes_out.append(planes)
        else:
            imgs.append(img.cpu().numpy().astype(np.uint16))
    if not fields:
        return np.concatenate(imgs)
    return (torch.cat(imgs), {k: torch.cat([p[k] for p in planes_out])
                              for k in planes_out[0]})
