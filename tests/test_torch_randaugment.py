"""The port's RandAugment (``mrla_tpu_torch/data/randaugment.py``) against
the JAX package's: each of the 16 ops on the same image, level and sign,
at three levels and both signs (``atol=1e-3`` in 0..255; equalize and
posterize, integer arithmetic, exactly), then ``rand_augment``'s batching
against the ops applied image by image with the same draws."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.data import randaugment as j_ra
from mrla_tpu_torch.data import randaugment as ra

LEVELS = (2.5, 7.0, 10.0)
EXACT = ("_equalize", "_posterize")
H, W = 20, 27  # not square: H and W must not swap


def _image(seed=0):
    """Smooth content with noise, integer-valued like a decoded image, and
    a flat patch (equalize and the histogram ops see ties)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([yy * 9.0, xx * 7.0, (yy + xx) * 4.0], -1)
    img = img + rng.integers(-20, 20, (H, W, 3))
    img[2:6, 3:9] = 77.0
    return np.clip(np.round(img), 0, 255).astype(np.float32)


@pytest.mark.parametrize("name", [op.__name__ for op in j_ra.OPS])
def test_each_op_matches_the_jax_op(name):
    j_op = getattr(j_ra, name)
    t_op = getattr(ra, name.lstrip("_"))
    img = _image()
    for level in LEVELS:
        for sign in (1.0, -1.0):
            want = np.asarray(j_op(jnp.asarray(img), jnp.float32(level),
                                   jnp.float32(sign)))
            got = t_op(torch.from_numpy(img)[None],
                       torch.tensor([level], dtype=torch.float32),
                       torch.tensor([sign], dtype=torch.float32))[0].numpy()
            assert got.shape == want.shape and got.dtype == np.float32
            if name in EXACT:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{level} {sign}")
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-3,
                                           err_msg=f"{level} {sign}")


def test_op_table_is_the_jax_table():
    assert [op.__name__ for op in ra.OPS] == [
        op.__name__.lstrip("_") for op in j_ra.OPS]


def test_ops_take_a_level_and_sign_per_image():
    """A batch of three images at three (level, sign) pairs equals the
    three single-image calls."""
    imgs = torch.from_numpy(np.stack([_image(s) for s in range(3)]))
    level = torch.tensor([2.5, 7.0, 10.0])
    sign = torch.tensor([1.0, -1.0, 1.0])
    for op in ra.OPS:
        batched = op(imgs, level, sign)
        for i in range(3):
            torch.testing.assert_close(
                batched[i], op(imgs[i:i + 1], level[i:i + 1],
                               sign[i:i + 1])[0], rtol=0, atol=1e-4,
                msg=op.__name__)


def test_rand_augment_applies_each_images_draws():
    images = torch.from_numpy(np.stack([_image(s) for s in range(6)])).to(
        torch.uint8)
    out = ra.rand_augment(torch.Generator().manual_seed(3), images,
                          num_layers=2)
    assert out.shape == images.shape and out.dtype == torch.float32
    assert torch.equal(out, ra.rand_augment(
        torch.Generator().manual_seed(3), images, num_layers=2))
    assert not torch.equal(out, ra.rand_augment(
        torch.Generator().manual_seed(4), images, num_layers=2))
    # the same draws, image by image
    g = torch.Generator().manual_seed(3)
    op = torch.randint(0, len(ra.OPS), (2, 6), generator=g)
    level = (9.0 + 0.5 * torch.randn(2, 6, generator=g)).clamp(0.0, 10.0)
    sign = torch.where(torch.rand(2, 6, generator=g) < 0.5, 1.0, -1.0)
    for i in range(6):
        x = images[i:i + 1].float()
        for layer in range(2):
            x = ra.OPS[int(op[layer, i])](x, level[layer, i:i + 1],
                                          sign[layer, i:i + 1])
        torch.testing.assert_close(out[i], x[0], rtol=0, atol=1e-4)
