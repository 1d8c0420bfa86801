"""K5 and K5 local as ``csrc/splat_region.cu`` decomposes them, modelled on
the CPU (``tests/torch_port_helpers.py`` ``k5_tiles_model``) and held bit
for bit against the fixed-point model of their sums (``k5_model``,
``k5_local_model``), which the card tests hold the kernels to.

The kernel gives each block a sub-tile of ``splat_plan(c)`` rows x 128
outputs of one 128 x 128 tile. The block scans the tile's source window,
sums in int64 what lands in its sub-tile and converts; the non-finite
sources outside the window, found through the max partials' slots, set NaN
at their taps in the sub-tile. Integer sums do not depend on their order,
so the decomposition must give exactly the same bits: every comparison
here is of the bits (``torch.equal`` on the int32 views, NaN included).
Inputs are seeded with numpy; no JAX.
"""

import numpy as np
import pytest
import torch

from sin_inn_tpu_torch.ops.cuda import splat as TK5
from sin_inn_tpu_torch.ops.offsets import tile_flow_offsets
from torch_port_helpers import k5_local_model, k5_model, k5_tiles_model
from torch_port_helpers import one_torch_thread  # noqa: F401

H, W = 180, 200          # neither a multiple of 128: ragged last tiles
BOUNDS = (8, 16)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _values(n, h, w, c, seed):
    rng = np.random.RandomState(seed)
    v = rng.rand(n, h, w, c).astype(np.float32)
    v[..., -1] = 1.0           # a coverage channel of ones
    return torch.from_numpy(v)


def _flow(n, h, w, amp, seed, drift=(0.0, 0.0)):
    """A seeded smooth flow of +-``amp`` px plus noise and a drift (x, y)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 6, 2)
        out.append(np.stack(
            [drift[0] + amp * np.sin(xx / 23.0 + yy / 17.0 + ph[0]),
             drift[1] + amp * np.cos(xx / 13.0 - yy / 29.0 + ph[1])], -1)
            + rng.randn(h, w, 2))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _beyond(fl, dy, dx):
    """Share of the pixels whose flow leaves the window's bounds."""
    return ((fl[..., 1].abs() > dy - 1) | (fl[..., 0].abs() > dx - 1)
            ).float().mean().item()


def _offsets(fl, cap_y):
    offs = tile_flow_offsets(fl, 128, 128, cap_y, 0)
    assert (offs.off_out[..., 1] != 0).any()
    return offs.off_out


@pytest.mark.parametrize("local", [False, True], ids=["static", "local"])
@pytest.mark.parametrize("c", [1, 3, 5, 8])
def test_tiles_model_is_the_fixed_point_model(c, local):
    """Two images of 180 x 200 (partial tiles in both axes), a flow that
    leaves the window at more than 5% of the pixels; the local form on
    offsets with rows shifted (a 20 px drift in y)."""
    n = 2
    v = _values(n, H, W, c, seed=c)
    if local:
        fl = _flow(n, H, W, 12.0, seed=10 + c, drift=(-6.0, 20.0))
        off = _offsets(fl, 24)
        ldy, ldx = 8, 16
        dev = fl - torch.stack([
            -off[..., 0].repeat_interleave(128, 1).repeat_interleave(128, 2),
            -off[..., 1].repeat_interleave(128, 1).repeat_interleave(128, 2)],
            -1)[:, :H, :W]
        assert _beyond(dev, ldy, ldx) > 0.05
        got = k5_tiles_model(v, fl, ldy, ldx, off)
        want = k5_local_model(v, fl, off, ldy, ldx)
    else:
        fl = _flow(n, H, W, 20.0, seed=10 + c)
        assert _beyond(fl, *BOUNDS) > 0.05
        got = k5_tiles_model(v, fl, *BOUNDS)
        want = k5_model(v, fl, *BOUNDS)
    assert _bits_equal(got, want)
    assert torch.isfinite(got).all() and got[..., -1].sum() > 0


@pytest.mark.parametrize("local", [False, True], ids=["static", "local"])
def test_tiles_model_non_finite_values(local):
    """Inf and NaN values, one of them carried far beyond its window: the
    window drops its taps, and the plain version's Inf x 0 puts NaN there,
    which only the flagged slots' walk can find."""
    n, c = 2, 5
    v = _values(n, H, W, c, seed=31)
    fl = _flow(n, H, W, 20.0, seed=32, drift=(0.0, 20.0) if local
               else (0.0, 0.0))
    v[0, 5, 7, 0] = float("inf")
    v[0, 5, 8, 0] = float("-inf")
    v[1, 100, 150, 2] = float("nan")
    v[1, 170, 190, 1] = float("-inf")
    fl[1, 170, 190] = torch.tensor([0.25, 0.5])     # in the window: -Inf
    v[0, 0, 0, 3] = float("inf")          # at the border
    v[0, 10, 10, 1] = float("inf")
    fl[0, 10, 10] = torch.tensor([100.25, 140.5])   # far beyond dy, dx
    if local:
        off = _offsets(fl, 24)
        got = k5_tiles_model(v, fl, *BOUNDS, off)
        want = k5_local_model(v, fl, off, *BOUNDS)
    else:
        got = k5_tiles_model(v, fl, *BOUNDS)
        want = k5_model(v, fl, *BOUNDS)
    assert _bits_equal(got, want)
    assert torch.isnan(want[0, 150, 110, 1])      # the dropped far tap
    assert torch.isneginf(want[1, 170, 190, 1])


def test_tiles_model_small_images():
    """Images smaller than a tile, C = 7 at 16-row sub-tiles."""
    v = _values(3, 40, 60, 7, seed=41)
    fl = _flow(3, 40, 60, 6.0, seed=42)
    assert _bits_equal(k5_tiles_model(v, fl, 4, 8), k5_model(v, fl, 4, 8))


def test_tiles_model_targets_outside_the_image():
    """Flows that carry sources off every edge, and NaN / Inf flows: their
    taps outside the image land on row or column 0 at weight 0, which
    counts where a value is not finite, so the chunks that hold them must
    not be skipped by the blocks that own row or column 0."""
    n, c = 1, 3
    v = _values(n, H, W, c, seed=51)
    fl = _flow(n, H, W, 30.0, seed=52)
    fl[0, :8] += torch.tensor([0.0, -60.0])       # above the image
    fl[0, -8:] += torch.tensor([0.0, 60.0])       # below it
    fl[0, :, :8] += torch.tensor([-60.0, 0.0])    # left of it
    fl[0, 40, 50] = torch.tensor([float("nan"), 0.5])
    fl[0, 60, 70] = torch.tensor([0.25, float("inf")])
    v[0, 40, 50, 1] = float("inf")
    v[0, 60, 70, 2] = float("nan")
    v[0, 3, 150, 0] = float("inf")               # its taps off the top
    got = k5_tiles_model(v, fl, *BOUNDS)
    want = k5_model(v, fl, *BOUNDS)
    assert _bits_equal(got, want)
    assert torch.isnan(want[0, 0, :, 0]).any()


@pytest.mark.parametrize("c", list(range(1, TK5.MAX_CHANNELS + 1)))
def test_plan_fits_shared_memory(c):
    rows, smem = TK5.splat_plan(c)
    assert smem == rows * 128 * (8 * c + 4) + 32 * 64 * 4
    assert smem <= 232448
    assert 128 % rows == 0 and rows == (32 if c <= 6 else 16)


def test_plan_refuses_what_the_kernel_cannot_take():
    for c in (0, TK5.MAX_CHANNELS + 1):
        with pytest.raises(ValueError, match="channels"):
            TK5.splat_plan(c)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 436, 1024, 5),
                                   (2, 180, 200, 8), (300, 240, 8, 3)])
def test_scratch_bytes(shape):
    """16 bytes a chunk of 128 pixels of a row, c + 1 words a slot of 16
    chunks."""
    n, h, w, c = shape
    chunks = n * h * -(-w // 128)
    assert TK5.scratch_bytes(*shape) == (chunks * 16
                                         + -(-chunks // 16) * (c + 1) * 4)


def test_scratch_at_the_flow_path_shape():
    """1 x 436 x 1024 x 5: 3,488 chunks, 218 slots, under 64 KB (a global
    accumulator would take 19.6 MB)."""
    assert TK5.scratch_bytes(1, 436, 1024, 5) == 3488 * 16 + 218 * 6 * 4
    assert TK5.scratch_bytes(1, 436, 1024, 5) < 64 * 1024
