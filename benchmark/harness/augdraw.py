"""The training augmentation's random choices, drawn on the host from a
seeded ``torch.Generator``: a copy of the port's
``ops/augment.draw_params`` (the reference's train Compose: D4 flip with
p 1; contrast with p 0.45, one of CLAHE, percentile stretch or contrast
and gamma; scaling 0.85-1.15 with p 0.25; rotation +-45 degrees with p
0.25; blur with sigma 1-2 and p 0.3; noise of 1-5% of the maximum with
p 0.3)."""

from __future__ import annotations

from typing import Dict

import torch


def draw(gen: torch.Generator, n: int, size: int) -> Dict[str, torch.Tensor]:
    def u():
        return torch.rand(n, generator=gen)

    def uniform(lo, hi):
        return u() * (hi - lo) + lo

    p = {"h": torch.randint(0, 8, (n,), generator=gen)}
    p["do_contrast"] = u() < 0.45
    p["branch"] = torch.randint(0, 3, (n,), generator=gen)
    p["lo_hi"] = torch.randint(0, 2, (n,), generator=gen)
    p["factor"] = uniform(0.75, 1.25)
    p["gamma"] = uniform(0.7, 1.3)
    do_scale, do_rot = u() < 0.25, u() < 0.25
    p["geo"] = do_scale | do_rot
    p["sx"] = torch.where(do_scale, uniform(0.85, 1.15), 1.0)
    p["sy"] = torch.where(do_scale, uniform(0.85, 1.15), 1.0)
    angle = torch.where(do_rot, torch.deg2rad(uniform(-45.0, 45.0)), 0.0)
    p["cos"], p["sin"] = torch.cos(-angle), torch.sin(-angle)
    p["do_blur"] = u() < 0.3
    p["sigma"] = torch.where(p["do_blur"], uniform(1.0, 2.0), 1e-3)
    p["do_noise"] = u() < 0.3
    p["pct"] = torch.randint(1, 6, (n,), generator=gen).to(
        torch.float32) / 100.0
    p["noise"] = torch.randn((int(p["do_noise"].sum()), size, size, 1),
                             generator=gen)
    return p
