"""Kernels K3 and K4: connected components and the root-rank relabel.

``ranked_components(mask)`` is what post-processing needs, the components
numbered 1..n in raster order of their last pixels:
``sequentialize_components(connected_components(mask))`` from one union-find
forest, with no plane of ids in between (``csrc/cc.cu::ranked_launch``).

``connected_components(mask)`` labels every pixel of a component with the
component's max linear index + 1 (8-connected by default), the unique fixed
point of ``microbeseg_tpu/ops/cc.py::connected_components``.
``sequentialize_components(labels)`` gives each pixel the raster-order rank
of its root (the pixel whose linear index + 1 equals its id), spread over
8-connected pixels of equal id: the fixed point of
``microbeseg_tpu/ops/cc.py::sequentialize_components``.

The JAX package runs both as neighbour-max sweep loops (with the Pallas
window warm starts ``cc_warmstart`` / ``rank_warmstart`` on big frames).  In
the port each is a CUDA union-find that links toward the larger index, at
every frame size (``csrc/cc.cu``): ``connected_components`` one cooperative
launch of tile-local forests in shared memory whose tile borders are merged
behind a grid barrier, the others three to five launches over every
pixel.  The plain versions below
run the JAX sweeps, checking convergence every 4 sweeps as the JAX loops'
``steps_per_check`` does; CPU tensors take them, CUDA tensors take the
kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from microbeseg_torch.kernels import _build

_STEPS_PER_CHECK = 4
_RANK_BLOCK = 256   # pixels per block of the ranked_components kernels


def _batch(x: torch.Tensor):
    return (x[None], True) if x.ndim == 2 else (x, False)


def _linear_ids(B: int, H: int, W: int, device) -> torch.Tensor:
    return (torch.arange(H * W, dtype=torch.int32, device=device) + 1
            ).view(1, H, W).expand(B, H, W)


def _neighbor_max(labels: torch.Tensor, connectivity: int) -> torch.Tensor:
    """max over the pixel and its neighbours (3x3, or the cross for
    connectivity 1), 0 outside the image."""
    H, W = labels.shape[-2:]
    p = F.pad(labels, (1, 1, 1, 1), value=0)
    out = labels
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) == (1, 1):
                continue
            if connectivity == 1 and dy != 1 and dx != 1:
                continue
            out = torch.maximum(out, p[:, dy:dy + H, dx:dx + W])
    return out


def connected_components_plain(mask: torch.Tensor,
                               connectivity: int = 2) -> torch.Tensor:
    """Neighbour-max propagation of linear-index labels to the fixed point,
    batched over a leading axis.  (B, H, W) or (H, W) bool -> int32."""
    mask, squeeze = _batch(mask.to(torch.bool))
    B, H, W = mask.shape
    labels = torch.where(mask, _linear_ids(B, H, W, mask.device), 0)
    # H * W sweeps bound the geodesic diameter of any component
    for _ in range(0, H * W, _STEPS_PER_CHECK):
        new = labels
        for _ in range(_STEPS_PER_CHECK):
            new = torch.where(mask, _neighbor_max(new, connectivity), 0)
        if torch.equal(new, labels):
            break
        labels = new
    return labels[0] if squeeze else labels


def sequentialize_components_plain(labels: torch.Tensor) -> torch.Tensor:
    """Root ranks by one prefix sum, spread by neighbour-max sweeps gated on
    equal ids.  (B, H, W) or (H, W) int -> int32."""
    labels, squeeze = _batch(labels.to(torch.int32))
    B, H, W = labels.shape
    rank = _root_ranks(labels)
    mask = labels > 0
    lp = F.pad(labels, (1, 1, 1, 1), value=0)

    def spread(r):
        rp = F.pad(r, (1, 1, 1, 1), value=0)
        out = r
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if (dy, dx) == (1, 1):
                    continue
                same = lp[:, dy:dy + H, dx:dx + W] == labels
                out = torch.maximum(
                    out, torch.where(same, rp[:, dy:dy + H, dx:dx + W], 0))
        return torch.where(mask, out, 0)

    for _ in range(0, H * W, _STEPS_PER_CHECK):
        new = rank
        for _ in range(_STEPS_PER_CHECK):
            new = spread(new)
        if torch.equal(new, rank):
            break
        rank = new
    return rank[0] if squeeze else rank


def _root_ranks(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32: at each root (labels == linear index + 1) its
    raster-order rank among the image's roots, 0 elsewhere."""
    B, H, W = labels.shape
    roots = (labels == _linear_ids(B, H, W, labels.device)) & (labels > 0)
    seq = torch.cumsum(roots.view(B, -1).to(torch.int32), dim=1,
                       dtype=torch.int32).view(B, H, W)
    return torch.where(roots, seq, 0)


def _launch(name: str, entry: str, n_ptrs: int, n_ints: int, args) -> None:
    _build.check(_build.entry("cc", entry, n_ptrs, n_ints)(*args), name)
    _build.count_launch(name)


def _cuda_mask(mask: torch.Tensor, connectivity: int, what: str):
    """(B, H, W) contiguous bool mask of a CUDA tensor, squeeze flag."""
    if mask.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {mask.device}")
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    B, H, W = (1, *mask.shape) if mask.ndim == 2 else mask.shape
    if B * H * W >= 1 << 31:
        raise ValueError(f"{what}: {B} x {H} x {W} pixels do not fit the "
                         "kernel's int32 indices")
    if mask.dtype != torch.bool:
        mask = mask.to(torch.bool)
    return _batch(mask.contiguous())


def connected_components(mask: torch.Tensor,
                         connectivity: int = 2) -> torch.Tensor:
    """Label connected regions: (B, H, W) or (H, W) bool -> int32 ids (the
    component's max linear index + 1, 0 for background).  connectivity 2 =
    8-connected, 1 = 4-connected.  CPU tensors run the plain version; CUDA
    tensors one launch of ``csrc/cc.cu::cc_tile_kernel``, with the parent
    plane kept in the output."""
    if mask.device.type == "cpu":
        return connected_components_plain(mask, connectivity)
    m, squeeze = _cuda_mask(mask, connectivity, "connected_components")
    B, H, W = m.shape
    out = torch.empty_like(m, dtype=torch.int32)
    _launch("connected_components", "cc_tile_launch", 2, 4,
            (_build.ptr(m), _build.ptr(out), B, H, W, connectivity,
             _build.stream_ptr(m)))
    return out[0] if squeeze else out


def ranked_components_plain(mask: torch.Tensor,
                            connectivity: int = 2) -> torch.Tensor:
    """The components of ``mask`` numbered 1..n in raster order of their
    roots (each component's last pixel): the two plain versions in turn.
    (B, H, W) or (H, W) bool -> int32."""
    return sequentialize_components_plain(
        connected_components_plain(mask, connectivity))


def ranked_components(mask: torch.Tensor,
                      connectivity: int = 2) -> torch.Tensor:
    """``sequentialize_components(connected_components(mask, connectivity))``
    in one kernel call: (B, H, W) or (H, W) bool -> int32 ranks 1..n per
    image, 0 for background.  CPU tensors run the plain version."""
    if mask.device.type == "cpu":
        return ranked_components_plain(mask, connectivity)
    m, squeeze = _cuda_mask(mask, connectivity, "ranked_components")
    B, H, W = m.shape
    out = torch.empty((B, H, W), dtype=torch.int32, device=m.device)
    parent = torch.empty((B, H, W), dtype=torch.int32, device=m.device)
    # roots per block of _RANK_BLOCK pixels, then their prefix per image
    counts = torch.empty((B, -(-H * W // _RANK_BLOCK)), dtype=torch.int32,
                         device=m.device)
    _launch("ranked_components", "ranked_launch", 4, 4,
            (_build.ptr(m), _build.ptr(parent), _build.ptr(out),
             _build.ptr(counts), B, H, W, connectivity,
             _build.stream_ptr(m)))
    return out[0] if squeeze else out


def sequentialize_components(labels: torch.Tensor) -> torch.Tensor:
    """Map CC ids to sequential ranks 1..n in raster order of the roots:
    (B, H, W) or (H, W) int -> int32.  Exact for any int input (pixels whose
    id has no 8-connected root get 0).  CPU tensors run the plain
    version."""
    if labels.device.type == "cpu":
        return sequentialize_components_plain(labels)
    if labels.device.type != "cuda":
        raise RuntimeError(f"sequentialize_components: unsupported device "
                           f"{labels.device}")
    lab, squeeze = _batch(labels.to(torch.int32).contiguous())
    B, H, W = lab.shape
    # the prefix count of the roots stays a PyTorch cumsum, as in JAX
    rank0 = _root_ranks(lab).contiguous()
    out = torch.empty((B, H, W), dtype=torch.int32, device=lab.device)
    parent = torch.empty((B, H, W), dtype=torch.int32, device=lab.device)
    _launch("sequentialize_components", "rank_launch", 4, 3,
            (_build.ptr(lab), _build.ptr(rank0), _build.ptr(parent),
             _build.ptr(out), B, H, W, _build.stream_ptr(lab)))
    return out[0] if squeeze else out


def _presence(labels: torch.Tensor):
    """(flat int32 ids, id bound, presence table over 0..bound, 0 unset).
    The bound, max(size, 65535), covers CC linear-index ids and uint16 mask
    ids; larger ids share the bound's entry."""
    flat = labels.to(torch.int32).reshape(-1)
    bound = max(flat.numel(), 65535)
    present = torch.zeros(bound + 1, dtype=torch.int32, device=flat.device)
    present[torch.clamp(flat, 0, bound).to(torch.int64)] = 1
    present[0] = 0
    return flat, bound, present


def relabel_sequential(labels: torch.Tensor) -> torch.Tensor:
    """Map positive ids to 1..n in increasing order (0 and negative ids give
    0), as ``microbeseg_tpu/ops/cc.py::relabel_sequential``: a presence
    table and its prefix sum, no sort.  Returns int32 of the input's
    shape."""
    flat, bound, present = _presence(labels)
    ranks = torch.cumsum(present, 0, dtype=torch.int32)
    idx = torch.clamp(flat, 0, bound).to(torch.int64)
    out = torch.where(flat > 0, ranks[idx], 0)
    return out.view(labels.shape)


def num_labels(labels: torch.Tensor) -> torch.Tensor:
    """Count distinct positive ids (bounded as in ``relabel_sequential``):
    a 0-dim int tensor."""
    return _presence(labels)[2].sum()
