"""The port's linear layer attention against the JAX package's: the three
steps of ``ops.linear_la`` threading their state over three layers (the
full-rank one also with its state carried as an SVD, and truncated), the
``nn.linear_la`` modules on Flax-initialised projections, the
``MLALayer`` alias, and ``svd_compress`` / ``svd_reconstruct``.

An SVD's factors are unique only up to the signs of paired singular
vectors and their order among equal singular values, so the SVD state is
compared by its reconstruction.  Inputs from seeded numpy; fp32, rtol
1e-5, atol 1e-6 as ``tests/test_torch_ops.py`` (1e-4 / 1e-5 where the
state passes through an SVD)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu import nn as jnn
from mrla_tpu.ops import linear_la as jla
from mrla_tpu.ops.mrla import MRLAParams as JParams
from mrla_tpu_torch import nn as tnn
from mrla_tpu_torch.ops import linear_la as tla
from mrla_tpu_torch.ops.mrla import MRLAParams as TParams

OPS = dict(rtol=1e-5, atol=1e-6)
SVD = dict(rtol=1e-4, atol=1e-5)
B, H, W, C = 2, 4, 4, 8


def _params(seed, k=3):
    rng = np.random.default_rng(seed)
    wq, wk = rng.uniform(-1, 1, (2, k)).astype(np.float32)
    wv = (rng.standard_normal((3, 3, 1, C)) / 3).astype(np.float32)
    j = JParams(jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv))
    t = TParams(torch.from_numpy(wq), torch.from_numpy(wk),
                torch.from_numpy(wv.transpose(3, 2, 0, 1).copy()))
    return j, t


def _maps(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, W, C)).astype(np.float32)
            for _ in range(n)]


STEPS = {
    "full": (lambda x, s, z, p: jla.linear_la_step(x, s, z, p),
             lambda x, s, z, p: tla.linear_la_step(x, s, z, p)),
    "channel": (lambda x, s, z, p: jla.linear_cla_step(x, s, z, p),
                lambda x, s, z, p: tla.linear_cla_step(x, s, z, p)),
    "group": (lambda x, s, z, p: jla.linear_gla_step(x, s, z, p, groups=2),
              lambda x, s, z, p: tla.linear_gla_step(x, s, z, p, groups=2)),
    "full_svd": (
        lambda x, s, z, p: jla.linear_la_step(x, s, z, p, svd=True),
        lambda x, s, z, p: tla.linear_la_step(x, s, z, p, svd=True)),
    "full_svd_rank2": (
        lambda x, s, z, p: jla.linear_la_step(x, s, z, p, svd=True,
                                              svd_rank=2),
        lambda x, s, z, p: tla.linear_la_step(x, s, z, p, svd=True,
                                              svd_rank=2)),
}


@pytest.mark.parametrize("kind", list(STEPS))
def test_steps_thread_their_state_as_jax(kind):
    j_step, t_step = STEPS[kind]
    jp, tp = _params(0)
    js = jz = ts = tz = None
    svd = kind.startswith("full_svd")
    tol = SVD if svd else OPS
    for x in _maps(1):
        jo, js, jz = j_step(jnp.asarray(x), js, jz, jp)
        to, ts, tz = t_step(torch.from_numpy(x), ts, tz, tp)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **OPS)
        if svd:  # by reconstruction
            np.testing.assert_allclose(
                tla.svd_reconstruct(ts).numpy(),
                np.asarray(jla.svd_reconstruct(js)), **SVD)
        else:
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), **OPS)


def test_svd_compress_reconstructs():
    s = np.random.default_rng(2).standard_normal((2, 6, 10)).astype(
        np.float32)
    fac = tla.svd_compress(torch.from_numpy(s))
    np.testing.assert_allclose(tla.svd_reconstruct(fac).numpy(), s, **SVD)
    u, sig, vh = tla.svd_compress(torch.from_numpy(s), rank=3)
    assert u.shape == (2, 6, 3) and sig.shape == (2, 3) and \
        vh.shape == (2, 3, 10)
    want = jla.svd_reconstruct(jla.svd_compress(jnp.asarray(s), rank=3))
    np.testing.assert_allclose(tla.svd_reconstruct((u, sig, vh)).numpy(),
                               np.asarray(want), **SVD)


def _load_proj(port, proj):
    """Flax ``proj`` (wq, wk [k]; wv [3,3,1,C]) -> the port's W{q,k,v}."""
    port.Wq.weight.data = torch.from_numpy(np.array(proj["wq"])).reshape(
        1, 1, -1)
    port.Wk.weight.data = torch.from_numpy(np.array(proj["wk"])).reshape(
        1, 1, -1)
    port.Wv.weight.data = torch.from_numpy(
        np.array(proj["wv"]).transpose(3, 2, 0, 1).copy())


@pytest.mark.parametrize("kind", ["full", "channel", "group"])
def test_modules_match_flax(kind):
    flax_mod, port = {
        "full": (jnn.LinearLayerAttention(), tnn.LinearLayerAttention(C)),
        "channel": (jnn.LinearCLA(), tnn.LinearCLA(C)),
        "group": (jnn.LinearGLA(dim_pergroup=4),
                  tnn.LinearGLA(C, dim_pergroup=4)),
    }[kind]
    xs = _maps(3, n=2)
    v = flax_mod.init(jax.random.key(0), jnp.asarray(xs[0]), None, None)
    _load_proj(port, v["params"]["proj"])
    js = jz = ts = tz = None
    for x in xs:
        jo, js, jz = flax_mod.apply(v, jnp.asarray(x), js, jz)
        to, ts, tz = port(torch.from_numpy(x).permute(0, 3, 1, 2), ts, tz)
        np.testing.assert_allclose(to.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(jo), **OPS)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **OPS)
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), **OPS)


def test_mla_alias_is_the_light_layer():
    assert tnn.MLALayer is tnn.MRLALightLayer
    x = _maps(4, n=1)[0]
    flax_mod = jnn.MLALayer(dim_perhead=4)
    v = flax_mod.init(jax.random.key(0), jnp.asarray(x))
    port = tnn.MLALayer(C, dim_perhead=4)
    _load_proj(port, v["params"]["proj"])
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(flax_mod.apply(v, jnp.asarray(x))),
                               **OPS)
