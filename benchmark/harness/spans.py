"""What the port's own spans and counters recorded while the traced
sub-window ran (``microbeseg_torch.utils.profiling``, which records only
while a profiler does).  Empty where the program keeps none: untraced
runs, and a program without the recorder."""

from __future__ import annotations

from typing import Optional


def recorded() -> dict:
    """``{"spans": {...}, "counters": {...}}`` of the port's recorder, or
    empty dicts where it holds nothing."""
    from microbeseg_torch.utils import profiling

    summary = getattr(profiling, "summary", None)
    out = summary() if summary is not None else {}
    return {"spans": out.get("spans", {}), "counters": out.get("counters", {})}


def device_s(name: str) -> Optional[float]:
    """The device seconds between the edges of the port's spans ``name``,
    summed; None where none was recorded."""
    rec = recorded()["spans"].get(name)
    return None if rec is None else rec.get("device_s")


def host_s(name: str) -> Optional[float]:
    """The host seconds of the port's spans ``name``, summed; None where
    none was recorded."""
    rec = recorded()["spans"].get(name)
    return None if rec is None else rec.get("host_s")


def per_mpx_ms(seconds: Optional[float], traced: Optional[dict]
               ) -> Optional[float]:
    """``seconds`` in ms per megapixel segmented in the traced sub-window."""
    if not seconds or not traced or not traced.get("pixels"):
        return None
    return seconds * 1e3 / (traced["pixels"] / 1e6)
