"""Port vs JAX package: training augmentation (``ops/augment.py``) and the
dynamic blur (``ops/filters.gaussian_blur_dynamic``).

The two packages draw from different generators (threefry against Philox),
so the apply step is held given JAX's own draws: the test re-draws each
sample's parameters with ``jax.random``, split as ``augment_train`` splits
them, and hands them to ``apply_params``.  Held bit for bit: the D4 flip on
all 8 elements, the bisection quantiles, the two-pass resample (orders 0
and 1, scales and +-45 degrees) against JAX's function run op by op.  Held
to 1e-6 relative: the stretch and gamma branches and the blur.  The whole
apply step is held against the jitted ``augment_batch``; the draw only by
its gate and branch frequencies.  Images are 48^2 and 64^2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microbeseg_tpu.ops import augment as ja
from microbeseg_tpu.ops.filters import gaussian_blur_dynamic as jblur
from microbeseg_torch.ops import augment as ta
from microbeseg_torch.ops.filters import gaussian_blur_dynamic

S = 48


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(seed, n=4, size=S, channels=1):
    """Microscopy-like float32 intensities in [0, 65535]: blobs on a
    noisy background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    out = np.empty((n, size, size, channels), np.float32)
    for i in range(n):
        for c in range(channels):
            img = rng.normal(6000, 900, (size, size))
            for _ in range(5):
                cy, cx = rng.integers(4, size - 4, 2)
                r = rng.uniform(3, 9)
                img += 30000 * (((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r)
            out[i, ..., c] = np.clip(img, 0, 65535)
    return out


def _jax_params(key, shape):
    """One sample's parameters as ``augment_train`` draws them from
    ``key``, in the port's form (rotation as cos / sin of -angle)."""
    keys = jax.random.split(key, 8)
    k1, k2, k3 = jax.random.split(keys[2], 3)
    kf, kg = jax.random.split(k3)
    ks1, ks2, kr = jax.random.split(keys[3], 3)
    do_scale = jax.random.uniform(keys[4]) < 0.25
    do_rot = jax.random.uniform(keys[5]) < 0.25
    angle = jnp.where(do_rot, jnp.deg2rad(jax.random.uniform(
        kr, (), minval=-45.0, maxval=45.0)), 0.0)
    do_blur = jax.random.uniform(keys[6]) < 0.3
    kn1, kn2, kn3 = jax.random.split(jax.random.fold_in(key, 17), 3)
    p = dict(
        h=jax.random.randint(keys[0], (), 0, 8),
        do_contrast=jax.random.uniform(keys[1]) < 0.45,
        branch=jax.random.randint(k1, (), 0, 3),
        lo_hi=jax.random.randint(k2, (), 0, 2),
        factor=jax.random.uniform(kf, (), minval=0.75, maxval=1.25),
        gamma=jax.random.uniform(kg, (), minval=0.7, maxval=1.3),
        geo=do_scale | do_rot,
        sx=jnp.where(do_scale, jax.random.uniform(
            ks1, (), minval=0.85, maxval=1.15), 1.0),
        sy=jnp.where(do_scale, jax.random.uniform(
            ks2, (), minval=0.85, maxval=1.15), 1.0),
        cos=jnp.cos(-angle), sin=jnp.sin(-angle),
        do_blur=do_blur,
        sigma=jnp.where(do_blur, jax.random.uniform(
            keys[7], (), minval=1.0, maxval=2.0) + 0.0, 1e-3),
        do_noise=jax.random.uniform(kn1) < 0.3,
        pct=jax.random.randint(kn2, (), 1, 6).astype(jnp.float32) / 100.0,
        noise=jax.random.normal(kn3, shape))
    return {k: np.asarray(v) for k, v in p.items()}


def _batch_params(key, n, shape):
    """``augment_batch``'s per-sample keys, drawn and stacked; the noise
    kept only for the samples that drew it."""
    per = [_jax_params(k, shape) for k in jax.random.split(key, n)]
    p = {k: torch.from_numpy(np.stack([q[k] for q in per]))
         for k in per[0]}
    p["noise"] = p["noise"][p["do_noise"]]
    for k in ("h", "branch", "lo_hi"):
        p[k] = p[k].to(torch.int64)
    return p


# --- exact stages -----------------------------------------------------------

@pytest.mark.parametrize("h", range(8))
def test_d4_matches_jax(h):
    """Each of the 8 D4 elements, bit for bit, on a 2-channel image."""
    x = _images(h, n=1, channels=2)
    want = np.asarray(ja._d4(jnp.asarray(x[0]), h))
    got = ta._d4(torch.from_numpy(x), torch.tensor([h]))[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qs", [(0.002, 0.998), (0.001, 0.999),
                                (0.0, 1.0), (0.5, 0.25)])
def test_quantiles_match_jax(qs):
    """The 22-step bisection, bit for bit (not ``torch.quantile``, which
    finds another value), per sample of a batch."""
    x = _images(7, n=3)
    q = np.asarray(qs, np.float32)
    want = np.stack([np.asarray(jax.jit(ja._quantiles)(
        jnp.asarray(xi), jnp.asarray(q))) for xi in x])
    got = ta._quantiles(torch.from_numpy(x), torch.from_numpy(
        np.tile(q, (3, 1)))).numpy()
    np.testing.assert_array_equal(got, want)


def _geometry(seed, n, scale=True, rotate=True):
    """(angle, sy, sx) per sample; with rotation the first two angles are
    +-45 degrees, the ends of the drawn range."""
    rng = np.random.default_rng(seed)
    angle = np.zeros(n, np.float32)
    if rotate:
        angle = rng.uniform(-np.pi / 4, np.pi / 4, n).astype(np.float32)
        angle[:2] = np.float32(np.pi / 4), np.float32(-np.pi / 4)
    sy, sx = (rng.uniform(0.85, 1.15, (2, n)) if scale
              else np.ones((2, n))).astype(np.float32)
    return angle, sy, sx


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("scale,rotate", [(True, False), (False, True),
                                          (True, True)],
                         ids=["scale", "rotate", "both"])
def test_affine_resample_matches_jax(order, scale, rotate):
    """The two-pass resample bit for bit against JAX's function run op by
    op: bfloat16 image, weights and first pass; a gather of the two taps
    where JAX multiplies a (K, H, W) weight tensor; the ``valid`` cut.
    Angles include +-45 degrees; the image has 2 channels."""
    x = _images(3, n=4, channels=2)
    angle, sy, sx = _geometry(order * 10 + scale + 2 * rotate, 4,
                              scale, rotate)
    want = np.stack([np.asarray(ja._affine_resample(
        jnp.asarray(x[i]), angle[i], sy[i], sx[i], order=order))
        for i in range(4)])
    ca = np.asarray(jnp.cos(-jnp.asarray(angle)))
    sa = np.asarray(jnp.sin(-jnp.asarray(angle)))
    got = ta._affine_resample(*(torch.from_numpy(a) for a in
                                (x, ca, sa, sy, sx)), order=order).numpy()
    np.testing.assert_array_equal(got, want)


def test_affine_resample_jitted_differs_by_xla_contraction():
    """Inside ``jax.jit`` XLA contracts the position arithmetic into
    multiply-adds, so a few positions move by an ulp and their bfloat16
    weights round the other way: measured 39 of 27,648 values (0.14%),
    at most 229 (0.35% of the image's maximum, one bfloat16 step of the
    value).  Held: at most 1% of the values differ, each by at most 2^-7
    of the image's maximum."""
    x = _images(4, n=6, channels=2)
    angle, sy, sx = _geometry(5, 6)
    f = jax.jit(jax.vmap(lambda a, b, c, d: ja._affine_resample(
        a, b, c, d, order=1)))
    want = np.asarray(f(jnp.asarray(x), angle, sy, sx))
    ca = np.asarray(jnp.cos(-jnp.asarray(angle)))
    sa = np.asarray(jnp.sin(-jnp.asarray(angle)))
    got = ta._affine_resample(*(torch.from_numpy(a) for a in
                                (x, ca, sa, sy, sx)), order=1).numpy()
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 0.01
    assert diff.max() <= x.max() * 2.0 ** -7


# --- stages within 1e-6 -------------------------------------------------------

def _contrast_keys(branch, n):
    """The first ``n`` keys PRNGKey(0), (1), ... whose ``_contrast`` draw
    picks ``branch``."""
    keys, seed = [], 0
    while len(keys) < n:
        key = jax.random.PRNGKey(seed)
        if int(jax.random.randint(jax.random.split(key, 3)[0], (), 0,
                                  3)) == branch:
            keys.append(key)
        seed += 1
    return keys


@pytest.mark.parametrize("branch", [1, 2], ids=["stretch", "gamma"])
def test_contrast_branches_match_jax(branch):
    """The percentile stretch and the contrast + gamma branch, each given
    JAX's draws, within 1e-6 of the image range (measured: the stretch
    equal, the gamma branch 1.8e-7 of the range)."""
    x = _images(11 + branch, n=3)
    keys = _contrast_keys(branch, 3)
    want = np.stack([np.asarray(jax.jit(ja._contrast)(k, jnp.asarray(xi)))
                     for k, xi in zip(keys, x)])
    split = [jax.random.split(k, 3) for k in keys]
    if branch == 1:
        lo_hi = torch.tensor([int(jax.random.randint(k[1], (), 0, 2))
                              for k in split])
        got = ta._stretch_branch(torch.from_numpy(x), lo_hi)
    else:
        kfg = [jax.random.split(k[2]) for k in split]
        factor = torch.tensor([float(jax.random.uniform(
            kf, (), minval=0.75, maxval=1.25)) for kf, _ in kfg])
        gamma = torch.tensor([float(jax.random.uniform(
            kg, (), minval=0.7, maxval=1.3)) for _, kg in kfg])
        got = ta._gamma_branch(torch.from_numpy(x), factor, gamma)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * 65535)


def test_clahe_branch_matches_jax():
    """The CLAHE branch on the JAX branch's own input scaling, within the
    CLAHE tolerance of the inference tests (a bfloat16 table entry may
    round the other way): 4e-3 of the range (measured 1.8e-7)."""
    x = _images(21, n=2)
    key = _contrast_keys(0, 1)[0]
    want = np.stack([np.asarray(jax.jit(ja._contrast)(key, jnp.asarray(xi)))
                     for xi in x])
    got = ta._clahe_branch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3 * 65535)


@pytest.mark.parametrize("sigmas", [(1.0, 1.37, 2.0), (1e-3, 1.5, 1e-3)])
def test_gaussian_blur_dynamic_matches_jax(sigmas):
    """One sigma per sample of a batch, against JAX's function per sample
    (which blurs the trailing two axes: on (H, W, 1) the width and the
    channel), within 1e-6 relative (measured 6.2e-7); sigma 1e-3, the
    pipeline's no-blur value, is the identity on both sides."""
    x = _images(31, n=3)
    sig = np.asarray(sigmas, np.float32)
    want = np.stack([np.asarray(jax.jit(jblur)(jnp.asarray(xi), s))
                     for xi, s in zip(x, sig)])
    got = gaussian_blur_dynamic(torch.from_numpy(x),
                                torch.from_numpy(sig)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 65535)
    for i, s in enumerate(sig):
        if s < 0.01:
            np.testing.assert_array_equal(got[i], x[i])


# --- the whole apply step and the draw -------------------------------------

@pytest.mark.parametrize("label_type", ["distance", "boundary"])
def test_apply_matches_augment_train(label_type):
    """``apply_params`` on JAX's draws against the jitted ``augment_batch``
    (16 samples of 48^2 whose draws cover every stage and branch).
    Held: images within one bfloat16 step of the range (2^-7 in [-1, 1])
    and within 1e-6 on >= 99% of the pixels (measured: 1.1e-4 at most,
    0.02% of the pixels above 1e-6); labels equal on >= 99% of the pixels
    (measured: boundary labels all equal, distance labels 0.008% differ,
    by at most 7.3e-4, where the jitted resample's multiply-adds move a
    weight, see above)."""
    n = 16
    key = jax.random.PRNGKey(3)
    x = _images(41, n=n)
    rng = np.random.default_rng(5)
    if label_type == "distance":
        labels = {"border_label": rng.uniform(0, 1, x.shape).astype(
            np.float32), "cell_label": rng.uniform(0, 1, x.shape).astype(
            np.float32)}
    else:
        labels = {"label": rng.integers(0, 3, x.shape).astype(np.int32)}
    want_img, want_lab = jax.jit(ja.augment_batch, static_argnames=(
        "label_type",))(key, jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in labels.items()},
                        label_type=label_type)
    p = _batch_params(key, n, x.shape[1:])
    for gate in ("do_contrast", "geo", "do_blur", "do_noise"):
        assert p[gate].any() and not p[gate].all(), gate
    got_img, got_lab = ta.apply_params(
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in labels.items()}, p, label_type)
    got_img = got_img.numpy()
    want_img = np.asarray(want_img)
    diff = np.abs(got_img - want_img)
    assert diff.max() <= 2.0 * 2.0 ** -8
    assert (diff > 1e-6).mean() <= 0.01
    for k in labels:
        g, w = got_lab[k].numpy(), np.asarray(want_lab[k])
        assert g.dtype == w.dtype
        assert (g != w).mean() <= 0.01
        assert np.abs(g.astype(np.float64) - w).max() <= (
            1 if label_type == "boundary" else 2.0 ** -7)


def test_draw_frequencies_within_binomial_bounds():
    """4096 draws: each gate and branch frequency within 5 binomial
    standard deviations of the pipeline's probability, and the ranges of
    the drawn values."""
    n = 4096
    p = ta.draw_params(torch.Generator().manual_seed(0), n, 8)

    def within(hits, prob):
        k = int(hits.sum())
        assert abs(k - n * prob) <= 5 * np.sqrt(n * prob * (1 - prob)), (
            k, prob)

    within(p["do_contrast"], 0.45)
    within(p["do_blur"], 0.3)
    within(p["do_noise"], 0.3)
    within(p["sx"] != 1.0, 0.25)
    within(p["cos"] != 1.0, 0.25)
    within(p["geo"], 1 - 0.75 * 0.75)
    for b in range(3):
        within(p["branch"] == b, 1 / 3)
    for h in range(8):
        within(p["h"] == h, 1 / 8)
    for pct in range(1, 6):
        within(torch.isclose(p["pct"], torch.tensor(pct / 100.0)), 1 / 5)
    within(p["lo_hi"] == 0, 0.5)
    assert p["noise"].shape == (int(p["do_noise"].sum()), 8, 8, 1)
    for k, lo, hi in (("factor", 0.75, 1.25), ("gamma", 0.7, 1.3),
                      ("sx", 0.85, 1.15), ("sy", 0.85, 1.15)):
        assert float(p[k].min()) >= lo and float(p[k].max()) <= hi
    blur = p["sigma"][p["do_blur"]]
    assert float(blur.min()) >= 1.0 and float(blur.max()) <= 2.0
    assert (p["sigma"][~p["do_blur"]] == np.float32(1e-3)).all()
    angle = torch.atan2(-p["sin"], p["cos"])
    assert float(angle.abs().max()) <= np.pi / 4 + 1e-6


def test_draw_and_apply_shapes_and_range():
    """``draw_params`` then ``apply_params``, the trainer's augmentation:
    shapes and dtypes kept, images in [-1, 1], the same generator seed the
    same batch."""
    x = torch.from_numpy(_images(51, n=5))
    lab = {"label": torch.zeros(x.shape, dtype=torch.int32)}

    def run():
        p = ta.draw_params(torch.Generator().manual_seed(1), 5, x.shape[1])
        return ta.apply_params(x, lab, p, "boundary")

    a, b = run(), run()
    assert a[0].shape == x.shape and a[1]["label"].dtype == torch.int32
    assert float(a[0].min()) >= -1.0 and float(a[0].max()) <= 1.0
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_normalize_val_matches_jax():
    x = _images(61, n=2).astype(np.uint16)
    np.testing.assert_array_equal(
        ta.normalize_val(torch.from_numpy(x.astype(np.int32))).numpy(),
        np.asarray(ja.normalize_val(jnp.asarray(x))))
