"""The port's synthetic inputs (v2e_tpu_torch.synthetic, on the CPU) against
the JAX package's (v2e_tpu.synthetic): the six host generators, the six
device renderers and the plugin loader.

Sizes are those of tests/test_device_synthetic.py.  The host generators are
numpy copies and must give equal frames.  The five uint8-level renderers
must equal both the JAX renderer on the same times and the port's own host
generator; particles, whose host painter draws in float64 and stores
float32, matches to float32 rounding on the same centers (1e-5 at a
background of 5, one ulp at the default 127).

At 346x260 the float32 renderers (the JAX package's and the port's alike)
leave a few pixels one level off the float64 host generators, where a
float32 time, angle or phase lands on the other side of a `floor` or a
comparison than its float64 value: `test_full_size_rounding` states the
counts.  `particles` draws from an unseeded generator; its tests patch
`np.random.default_rng` to one seeded generator, so both packages spawn
the same walkers.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import v2e_tpu.synthetic.device as jax_device
import v2e_tpu_torch.synthetic.device as port_device
from v2e_tpu_torch.synthetic import load_synthetic_input

GENERATORS = ("moving_dot", "single_linearly_moving_dot", "spots", "barberpole",
              "gradients", "particles")
# (width, height, arg_list, frames compared: None for all)
SIZES = {
    "moving_dot": (96, 80, ["--t_total", "0.005", "--radius", "30"], None),
    "single_linearly_moving_dot": (96, 64, [], 50),
    "spots": (96, 64, ["--total_time", "0.004"], None),
    "barberpole": (96, 64, ["--total_time", "0.002"], None),
    "gradients": (96, 32, ["--total_time", "0.003"], None),
    "particles": (96, 64, ["--total_time", "0.002", "--dt", "1e-4",
                           "--num_particles", "40"], None),
}


@pytest.fixture
def seeded_rng(monkeypatch):
    """Every np.random.default_rng() call returns the same seeded stream."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: real(7))


def make(package, name, arg_list=None, size=None):
    w, h, args, _ = SIZES[name] if size is None else size
    cls = getattr(importlib.import_module(f"{package}.synthetic.{name}"), name)
    return cls(width=w, height=h, preview=False,
               arg_list=args if arg_list is None else arg_list)


def collect(syn, n=None):
    frames, ts = [], []
    for _ in range(syn.total_frames() if n is None else n):
        fr, t = syn.next_frame()
        if fr is None:
            break
        frames.append(np.asarray(fr))
        ts.append(t)
    return np.stack(frames), np.array(ts)


@pytest.mark.parametrize("name", GENERATORS)
def test_host_generator_matches_jax(name, seeded_rng):
    jax_syn, port_syn = make("v2e_tpu", name), make("v2e_tpu_torch", name)
    assert port_syn.total_frames() == jax_syn.total_frames() > 0
    n = SIZES[name][3]
    want, want_t = collect(jax_syn, n)
    got, got_t = collect(port_syn, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_t, want_t)
    if n is None:  # both end with (None, the last time)
        assert port_syn.next_frame() == jax_syn.next_frame()


def jax_frames(name, syn, ts):
    """The JAX package's renderer, called as its generator calls it."""
    w, h = syn.width, syn.height
    t = jnp.asarray(ts)
    if name == "moving_dot":
        return jax_device.moving_dot_frames(t, w, h, syn.num_dots, float(syn.contrast),
                                            float(syn.bg), float(syn.radius))
    if name == "single_linearly_moving_dot":
        return jax_device.single_linearly_moving_dot_frames(t, w, h)
    if name == "spots":
        return jax_device.spots_frames(t, w, h, 1.5, float(syn.t_total), 20.0, 60.0)
    return getattr(jax_device, f"{name}_frames")(t, w, h)


@pytest.mark.parametrize("name", GENERATORS[:5])
def test_device_renderer_matches_jax_and_host(name):
    """The port's renderer, through its generator's device_frames, on the
    CPU: equal to the JAX renderer and to the port's host frames."""
    host, ts = collect(make("v2e_tpu_torch", name), SIZES[name][3])
    syn = make("v2e_tpu_torch", name)
    got = syn.device_frames(ts, "cpu")
    assert got.device.type == "cpu" and got.is_contiguous()
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_frames(name, syn, ts)))
    np.testing.assert_array_equal(got, host.astype(np.float32))
    assert syn.frame_number == len(ts)


def test_particles_renderer_matches_jax_and_host_draw():
    """Clustered centers (patches overlap often: the later particle's patch
    overwrites): the port's scatter against the JAX one and against the
    host painter's loop, within float32 rounding."""
    from v2e_tpu_torch.synthetic.draw import paint_gaussian_dots

    rng = np.random.default_rng(7)
    F, P, H, W = 4, 25, 48, 64
    centers = np.empty((F, P, 2), dtype=np.float32)
    centers[..., 0] = rng.uniform(-2, 24, (F, P))  # some patches off the sensor
    centers[..., 1] = rng.uniform(8, 24, (F, P))
    bg, fg, sigma = 5.0, 6.25, 1.0
    d = int(sigma * 2) + 1
    host = np.stack([paint_gaussian_dots(c, W, H, fg, bg, sigma, 2.0, d) for c in centers])
    got = port_device.particles_frames(centers, W, H, fg, bg, sigma, 2.0, d,
                                       device="cpu").numpy()
    want = np.asarray(jax_device.particles_frames(jnp.asarray(centers), W, H, fg, bg,
                                                  sigma, 2.0, d))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, host, atol=1e-5, rtol=0)


def test_particles_device_frames_match_walker(seeded_rng):
    """Centers from the seeded walker: the port's renderer against JAX's
    within one float32 ulp (the two libraries' exp differ in the last bit;
    at the default background of 127 and foreground of 158.75 an ulp is
    7.6e-6 or 1.5e-5, so the 1e-5 of the clustered test above, at a
    background of 5, is under one ulp here); device_frames against
    next_frame as the JAX package holds it (the centers are stored as
    float32, the host draws at float64 positions: 1e-3, and the same
    pixels lit)."""
    host, ts = collect(make("v2e_tpu_torch", "particles"))
    syn = make("v2e_tpu_torch", "particles")
    centers = make("v2e_tpu_torch", "particles").trajectory(ts)
    args = (syn.width, syn.height, float(syn.fg), float(syn.bg), float(syn.radius), 2.0,
            int(syn.radius * 2) + 1)
    want = np.asarray(jax_device.particles_frames(jnp.asarray(centers), *args))
    got = port_device.particles_frames(centers, *args, device="cpu").numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    dev = syn.device_frames(ts, "cpu").numpy()
    np.testing.assert_allclose(dev, host, atol=1e-3, rtol=0)
    lit = syn.bg + 0.01
    assert (host > lit).any()
    np.testing.assert_array_equal(dev > lit, host > lit)


# name -> (arg_list, frames, pixels one level off the host generator at
# 346x260 for the port's renderer and for the JAX package's, measured on
# the CPU)
FULL_SIZE = {
    "moving_dot": (["--t_total", "0.064"], 640, 10, 9),
    "barberpole": (["--total_time", "0.064"], 640, 326, 369),
    "gradients": (["--total_time", "0.064"], 640, 3380, 3380),
}


@pytest.mark.parametrize("name", sorted(FULL_SIZE))
def test_full_size_rounding(name):
    """640 frames at 346x260: every pixel of the port's renderer and of
    the JAX package's within one level of the host generator, and no more
    pixels off than measured.  The float32 inputs
    that decide them: moving_dot's dot centers (cos and sin of a float32
    angle, the exp of the profile) at a `floor` boundary of the dot's
    levels; barberpole's stripe phase (about 240 rad in float32, an error
    of some 1e-5 rad, times a slope of 254 levels per rad) at a `floor`
    boundary; gradients' bump position p = w2 + t * 300 with t rounded to
    float32, which moves p off an integer column, so that a column on one
    of the bump's edges takes the other side of its comparison (a whole
    column of 260 pixels in 13 of the frames)."""
    args, n, bound, jax_bound = FULL_SIZE[name]
    size = (346, 260, args, n)
    host, ts = collect(make("v2e_tpu_torch", name, size=size), n)
    syn = make("v2e_tpu_torch", name, size=size)
    host = host.astype(np.float32)
    for frames, most in ((syn.device_frames(ts, "cpu").numpy(), bound),
                         (np.asarray(jax_frames(name, syn, ts)), jax_bound)):
        diff = np.abs(frames - host)
        assert diff.max() <= 1.0
        assert int((diff > 0).sum()) <= most


def test_loader_maps_every_spelling_to_the_port():
    from v2e_tpu_torch.synthetic.moving_dot import moving_dot

    for path in ("scripts.moving_dot", "v2e_tpu.synthetic.moving_dot",
                 "v2e_tpu_torch.synthetic.moving_dot"):
        assert load_synthetic_input(path) is moving_dot
    for name in GENERATORS:
        assert load_synthetic_input(f"scripts.{name}").__module__ == \
            f"v2e_tpu_torch.synthetic.{name}"


def test_loader_errors():
    with pytest.raises(ImportError, match="no class named draw"):
        load_synthetic_input("v2e_tpu_torch.synthetic.draw")
    with pytest.raises(ImportError, match="could not import synthetic input"):
        load_synthetic_input("no_such_package.moving_dot_like")
