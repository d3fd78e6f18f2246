"""``csrc/rel_attention.cu``'s ``rel_attention_kernel``: its least time
over its mean device time a launch, in the traced sub-window.

One launch is the attention of one ViT block over a forward's tiles; the
port counts its maps (images x heads) as ``attention_maps``.  With N tokens
a tile ((tile_size / patch_size)^2, from the cell's mix and configuration)
and head width hd (embed_dim / num_heads), the least time is the larger of
two bounds: the two products, q k^T and the weights times v, 4 N^2 hd
operations a map (a multiply-add counts as 2, as the peak counts it), over
the tensor cores' bf16 rate (989 TFLOP/s, NVIDIA's H100 SXM data sheet,
dense); q, k, v and the output, bf16, read or written once, 8 N hd bytes a
map, over the HBM bandwidth (3.35 TB/s).  The relative-position terms are
left out of the bound: they are not work every implementation of the
attention must do."""

from benchmark.harness.common import HBM_BYTES_PER_S
from benchmark.harness.spans import recorded

KERNEL = "rel_attention_kernel"
TENSOR_FLOPS_PER_S = 989e12


def least_s(maps: float, n: int, hd: int) -> float:
    return max(maps * 4 * n * n * hd / TENSOR_FLOPS_PER_S,
               maps * 8 * n * hd / HBM_BYTES_PER_S)


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    names = [k for k in t.kernel_s if KERNEL in k]
    n = sum(t.kernel_n[k] for k in names)
    maps = recorded()["counters"].get("attention_maps")
    if not n or not maps:
        return None
    cfg, mix = ctx["cell"].config, ctx["cell"].traffic
    tokens = (mix["infer"]["tile_size"] // cfg["patch_size"]) ** 2
    hd = cfg["embed_dim"] // cfg["num_heads"]
    mean_s = sum(t.kernel_s[k] for k in names) / n
    return 100.0 * least_s(maps / n, tokens, hd) / mean_s
