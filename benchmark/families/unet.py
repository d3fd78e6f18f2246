"""The (D)U-Net of ``microbeseg_torch.config.ModelConfig``
(hip-satomi/microbeSEG ``src/utils/unets.py``): its keys, FLOP count,
weights' entries and CPU preset.  The network itself is
``benchmark/reference/unet.py``."""

from __future__ import annotations

from typing import Dict

from benchmark.reference.unet import forward_flops, state_shapes  # noqa: F401

KEYS = ("unet_type", "act_fun", "pool_method", "normalization", "ch_in",
        "ch_out", "filters")
# the first and the deepest level's filters (doubling between them): the
# widths, and with them the depth
PUBLISHED = {"filters": [64, 1024]}
WIDTHS = ("filters",)

# the averaging weights' border head: its output convolution is scaled so
# that its field stays below the cell field and both heads move the seeds
BORDER_SCALE = 0.5


def model_config(config: dict) -> Dict:
    """The ``ModelConfig`` fields of a configuration file."""
    return {k: (tuple(config[k]) if k == "filters" else config[k])
            for k in KEYS}


def tiny(config: dict) -> dict:
    """Filters 8 -> 32: three levels (five at full size)."""
    return dict(config, filters=[8, 32])


def averaging_scale(name: str, shape: tuple) -> float:
    return (BORDER_SCALE if name.startswith("decoder1Conv.") and shape[2] == 1
            else 1.0)
