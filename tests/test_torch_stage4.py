"""The port's ``use_stage4=True`` serving path against the JAX package, CPU.

The same numpy inputs and weights go to both sides.  The JAX stage kernel
runs in interpret mode, as the JAX package's own test runs it; on CPU
tensors the port's ``stage4_resident`` runs its plain version.  Tolerances:
the JAX stage test's own 1e-4 (max error over max value, fp32) on the
kernel, and the JAX serving tests' rtol 2e-3 / atol 3e-4 on logits."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrla_tpu.kernels.mrla_stage4 as j_s4mod
import mrla_tpu.serving.resnet_mrlal as j_eng
from mrla_tpu_torch.ckpt import serving_params_from_jax, state_dict_from_jax
from mrla_tpu_torch.kernels import (
    fused_epilogue,
    pack_stage4_params,
    stage4_resident,
    stage4_resident_reference,
)
from mrla_tpu_torch.serving import (
    attach_stage4,
    prepare_inference_params,
    resnet_mrlal_forward,
)
import mrla_tpu_torch.serving.resnet_mrlal as eng

from test_torch_resnet_mrlal import _flax_variables
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-3, 3e-4
REL = 1e-4


def _mk_block(rng, cin, c1, c, ktap, first):
    """One raw serving block in the JAX layout (HWIO kernels), numpy."""
    f = lambda scale, *s: rng.standard_normal(s).astype(np.float32) * scale
    p = {
        "k1": f(.05, 1, 1, cin, c1), "b1": f(.1, c1),
        "k2": f(.02, 3, 3, c1, c1), "b2": f(.1, c1),
        "k3": f(.02, 1, 1, c1, c), "b3": f(.1, c),
        "wq": f(.3, ktap), "wk": f(.3, ktap),
        "wv": f(.3, 3, 3, 1, c), "lam": f(.3, c),
        "bn_scale": 1 + f(.1, c), "bn_bias": f(.1, c),
    }
    if first:
        p["kd"] = f(.03, 1, 1, cin, c)
        p["bd"] = f(.1, c)
    return p


def _jax_tree(blocks):
    return {"blocks": [{k: jnp.asarray(v) for k, v in p.items()}
                       for p in blocks]}


def _port_blocks(blocks, dtype=torch.float32):
    return serving_params_from_jax({"blocks": blocks}, device="cpu",
                                   dtype=dtype)["blocks"]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _stage_inputs(x, p0):
    """ob and xs of the stage from its input map, by the port's convs."""
    x1 = eng._conv(x, p0["k1"], p0["b1"]).relu_()
    ob = eng._conv(x1, p0["k2"], p0["b2"], stride=2).relu_()
    return ob.contiguous(), x[:, ::2, ::2, :]


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX engine looks ``stage4_resident`` up in its module at call
    time; run it in interpret mode."""
    monkeypatch.setattr(
        j_s4mod, "stage4_resident",
        functools.partial(j_s4mod.stage4_resident, interpret=True))


@pytest.mark.parametrize("cin,c1,c,ktap", [(256, 128, 512, 5),
                                           (128, 64, 256, 3)])
def test_stage4_plain_matches_jax_kernel(cin, c1, c, ktap):
    rng = np.random.default_rng(0)
    raw = [_mk_block(rng, cin, c1, c, ktap, True),
           _mk_block(rng, c, c1, c, ktap, False),
           _mk_block(rng, c, c1, c, ktap, False)]
    x = rng.standard_normal((8, 14, 14, cin)).astype(np.float32)

    port = _port_blocks(raw)
    ob, xs = _stage_inputs(torch.from_numpy(x), port[0])
    assert not xs.is_contiguous()  # the strided view goes in as it is
    got = stage4_resident(ob, xs, pack_stage4_params(port, torch.float32))

    j = _jax_tree(raw)["blocks"]
    packed = j_s4mod.pack_stage4_params(j, dtype=jnp.float32)
    want = j_s4mod.stage4_resident(
        jnp.asarray(ob.numpy()), jnp.asarray(x[:, ::2, ::2, :]),
        {k: v for k, v in packed.items() if k not in ("heads", "ktap")},
        heads=packed["heads"], ktap=packed["ktap"], batch_tile=8,
        interpret=True)
    assert got.shape == (8, 7, 7, c)
    assert _rel(got.numpy(), want) < REL


# B = 3: the port has no gate on the batch size
@pytest.mark.parametrize("b", [8, 3])
def test_stage4_plain_matches_the_ports_block_chain(b):
    cin, c1, c, ktap = 128, 64, 256, 3
    rng = np.random.default_rng(1)
    port = _port_blocks([_mk_block(rng, cin, c1, c, ktap, True),
                         _mk_block(rng, c, c1, c, ktap, False),
                         _mk_block(rng, c, c1, c, ktap, False)])
    x = torch.from_numpy(
        rng.standard_normal((b, 14, 14, cin)).astype(np.float32))
    heads = c // 32
    y, _ = eng._block(x, port[0], 2, heads)
    y, _ = eng._block(y, port[1], 1, heads)
    want, _ = eng._block(y, port[2], 1, heads)

    stage4_resident.counter.reset()
    got = stage4_resident(*_stage_inputs(x, port[0]),
                          pack_stage4_params(port, torch.float32))
    counter = stage4_resident.counter
    assert (counter.calls, counter.launches, dict(counter.by_shape)) \
        == (1, 0, {})
    assert _rel(got.numpy(), want.numpy()) < REL


def test_blocks_impl_with_stage4_matches_without_and_jax(jax_interpret):
    rng = np.random.default_rng(1)
    cin, c1, c, ktap, ca = 128, 64, 256, 3, 128
    layers = (2, 3)
    raw = [_mk_block(rng, cin, 64, ca, ktap, True),
           _mk_block(rng, ca, 64, ca, ktap, False),
           _mk_block(rng, ca, c1, c, ktap, True),
           _mk_block(rng, c, c1, c, ktap, False),
           _mk_block(rng, c, c1, c, ktap, False)]
    y = rng.standard_normal((8, 14, 14, cin)).astype(np.float32)

    j_sp = j_eng.attach_stage4(_jax_tree(raw), layers)
    want = j_eng._blocks_impl(j_sp, jnp.asarray(y), layers, 32, False,
                              use_stage4=True)

    sp = attach_stage4({"blocks": _port_blocks(raw)}, layers)
    stage4_resident.counter.reset()
    off = eng._blocks_impl(sp, torch.from_numpy(y), layers, 32)
    assert stage4_resident.counter.calls == 0
    on = eng._blocks_impl(sp, torch.from_numpy(y), layers, 32,
                          use_stage4=True)
    assert stage4_resident.counter.calls == 1  # the 7x7 final stage
    assert len(on) == len(off) == len(want) == 2
    for g_on, g_off, w in zip(on, off, want):
        assert g_on.shape == g_off.shape == w.shape
        assert _rel(g_on.numpy(), g_off.numpy()) < REL
        assert _rel(g_on.numpy(), w) < REL


def test_serving_logits_with_stage4_match_the_jax_engine(jax_interpret):
    """The slice as a whole: 224 px so that stage 4 is 7x7, full widths."""
    layers = (1, 1, 1, 3)
    _, variables = _flax_variables(layers, 32, seed=4)
    x = np.random.default_rng(4).standard_normal((8, 224, 224, 3)).astype(
        np.float32)
    j_sp = j_eng.attach_stage4(
        j_eng.prepare_inference_params(variables, layers=layers,
                                       dtype=jnp.float32), layers)
    want = np.asarray(j_eng.resnet_mrlal_forward(
        j_sp, jnp.asarray(x), layers=layers, microbatch=0, use_stage4=True))

    sp = attach_stage4(
        prepare_inference_params(state_dict_from_jax(variables),
                                 layers=layers, dtype=torch.float32,
                                 device="cpu"), layers)
    stage4_resident.counter.reset()
    fused_epilogue.counter.reset()
    got = resnet_mrlal_forward(sp, torch.from_numpy(x), layers=layers,
                               use_stage4=True).numpy()
    assert stage4_resident.counter.calls == 1
    # stage 3's block only: stage 4's three tails are inside the stage call
    assert fused_epilogue.counter.calls == 1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stage4_routing_follows_the_map_size():
    layers = (1, 1, 1, 3)
    _, variables = _flax_variables(layers, 32, seed=5)
    sp = attach_stage4(
        prepare_inference_params(state_dict_from_jax(variables),
                                 layers=layers, dtype=torch.float32,
                                 device="cpu"), layers)
    rng = np.random.default_rng(5)
    image = lambda px: torch.from_numpy(
        rng.standard_normal((1, px, px, 3)).astype(np.float32))

    x = image(160)  # stage 4 is 5x5: the per-block kernels serve it
    stage4_resident.counter.reset()
    on = resnet_mrlal_forward(sp, x, layers=layers, use_stage4=True)
    assert stage4_resident.counter.calls == 0
    off = resnet_mrlal_forward(sp, x, layers=layers)
    assert torch.equal(on, off)

    x = image(224)
    for n in (1, 2):
        resnet_mrlal_forward(sp, x, layers=layers, use_stage4=True)
        assert stage4_resident.counter.calls == n
    resnet_mrlal_forward(sp, x, layers=layers)  # off by default
    assert stage4_resident.counter.calls == 2
    del sp["stage4"]  # not attached: the flag alone routes nothing
    resnet_mrlal_forward(sp, x, layers=layers, use_stage4=True)
    assert stage4_resident.counter.calls == 2


def test_attach_stage4_rejects_other_final_stages():
    rng = np.random.default_rng(6)
    blocks = _port_blocks([_mk_block(rng, 256 if i else 128, 64, 256, 3, i == 0)
                           for i in range(3)])
    with pytest.raises(ValueError, match="3-block final stages"):
        attach_stage4({"blocks": blocks}, layers=(2, 2))
    no_kd = [{k: v for k, v in blocks[0].items() if k not in ("kd", "bd")},
             *blocks[1:]]
    with pytest.raises(ValueError, match="no downsample"):
        attach_stage4({"blocks": no_kd}, layers=(3,))
    assert "stage4" in attach_stage4({"blocks": blocks}, layers=(1, 3))


def test_stage4_plain_bf16_stays_near_fp32():
    """bf16 operands, fp32 sums: every product operand (weights, ob, xs, y,
    x1, o) carries a relative rounding error of 2^-9 at most, and the
    errors of the K terms of a sum are independent, so the output's error
    is a small multiple of 2^-8 of its largest value; 2% leaves room for
    the three chained blocks.  The output itself is rounded to bf16."""
    cin, c1, c, ktap = 128, 64, 256, 3
    rng = np.random.default_rng(7)
    raw = [_mk_block(rng, cin, c1, c, ktap, True),
           _mk_block(rng, c, c1, c, ktap, False),
           _mk_block(rng, c, c1, c, ktap, False)]
    x = torch.from_numpy(
        rng.standard_normal((4, 14, 14, cin)).astype(np.float32))
    port = _port_blocks(raw)
    ob, xs = _stage_inputs(x, port[0])
    want = stage4_resident_reference(
        ob, xs, pack_stage4_params(port, torch.float32))
    packed = pack_stage4_params(_port_blocks(raw, torch.bfloat16),
                                torch.bfloat16)
    assert packed["k2"].dtype == torch.bfloat16
    assert packed["b2"].dtype == packed["wv"].dtype == torch.float32
    got = stage4_resident_reference(ob.bfloat16(), xs.bfloat16(), packed)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want.numpy()) < 0.02


def test_stage4_wrapper_rejects_wrong_shapes():
    rng = np.random.default_rng(8)
    port = _port_blocks([_mk_block(rng, 256 if i else 128, 64, 256, 3, i == 0)
                         for i in range(3)])
    packed = pack_stage4_params(port, torch.float32)
    ob, xs = torch.zeros(2, 7, 7, 64), torch.zeros(2, 7, 7, 128)
    with pytest.raises(ValueError, match="ob must be"):
        stage4_resident(torch.zeros(2, 8, 8, 64), xs, packed)
    with pytest.raises(ValueError, match="xs must be"):
        stage4_resident(ob, torch.zeros(2, 6, 7, 128), packed)
    with pytest.raises(ValueError, match="contiguous channels"):
        stage4_resident(ob, torch.zeros(2, 7, 128, 7).transpose(2, 3), packed)
    with pytest.raises(ValueError, match="no kernel for device"):
        stage4_resident(ob.to("meta"), xs.to("meta"), packed)


@pytest.mark.parametrize("px", [64, 63])
def test_s2d_stem_matches_the_plain_stem_and_jax(px):
    """An even-sized image takes the 4x4 space-to-depth conv, an odd one
    the 7x7 conv; both agree with the plain stem and the JAX stem."""
    layers = (1, 1, 1, 1)
    _, variables = _flax_variables(layers, 32, seed=9)
    sd = state_dict_from_jax(variables)
    kw = dict(layers=layers, dtype=torch.float32, device="cpu")
    plain = prepare_inference_params(sd, **kw)["stem"]
    s2d = prepare_inference_params(sd, s2d=True, **kw)["stem"]
    assert "k_s2d" not in plain and s2d["k_s2d"].shape == (64, 12, 4, 4)
    j_stem = j_eng.prepare_inference_params(
        variables, layers=layers, dtype=jnp.float32, s2d=True)["stem"]
    # the packed kernel itself, through the converter
    conv = serving_params_from_jax({"stem": j_stem, "blocks": []},
                                   device="cpu", dtype=torch.float32)["stem"]
    torch.testing.assert_close(conv["k_s2d"], s2d["k_s2d"], rtol=1e-6,
                               atol=1e-7)

    x = np.random.default_rng(9).standard_normal((2, px, px, 3)).astype(
        np.float32)
    got = eng._stem(torch.from_numpy(x), s2d)
    assert got.shape == (2, (px + 3) // 4, (px + 3) // 4, 64)
    torch.testing.assert_close(got, eng._stem(torch.from_numpy(x), plain),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_eng._stem(jnp.asarray(x), j_stem)),
                               rtol=1e-5, atol=1e-5)


def test_with_head_false_serves_the_four_stage_maps():
    layers = (1, 1, 1, 1)
    _, variables = _flax_variables(layers, 32, seed=10)
    x = np.random.default_rng(10).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    j_sp = j_eng.prepare_inference_params(variables, layers=layers,
                                          dtype=jnp.float32, with_head=False)
    want = j_eng._trunk_impl(j_sp, jnp.asarray(x), layers, 32, False)
    sp = prepare_inference_params(state_dict_from_jax(variables),
                                  layers=layers, dtype=torch.float32,
                                  device="cpu", with_head=False)
    assert "fc" not in sp and "fc" not in j_sp
    got = eng._trunk_impl(sp, torch.from_numpy(x), layers, 32)
    assert [tuple(g.shape) for g in got] == [(2, 16, 16, 256), (2, 8, 8, 512),
                                             (2, 4, 4, 1024), (2, 2, 2, 2048)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_serving_params_from_jax_matches_prepare():
    """A raw block dict survives the conversion (layouts as the port's own
    ``prepare_inference_params`` makes them), and the JAX engine's whole
    tree converts to what the port prepares from the same variables."""
    rng = np.random.default_rng(11)
    raw = _mk_block(rng, 128, 64, 256, 3, True)
    blk = _port_blocks([raw])[0]
    assert set(blk) == set(raw)
    for name in ("k1", "k2", "k3", "kd"):
        assert blk[name].is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(
            blk[name].permute(2, 3, 1, 0).numpy(), raw[name])  # back to HWIO
    np.testing.assert_array_equal(blk["wv"].numpy(),
                                  raw["wv"].reshape(9, 256))
    for name in ("b1", "b2", "b3", "bd", "wq", "wk", "lam", "bn_scale",
                 "bn_bias"):
        np.testing.assert_array_equal(blk[name].numpy(), raw[name])

    layers = (1, 1, 1, 1)
    _, variables = _flax_variables(layers, 32, seed=11)
    j_sp = jax.device_get(j_eng.prepare_inference_params(
        variables, layers=layers, dtype=jnp.float32))
    got = serving_params_from_jax(j_sp, device="cpu", dtype=torch.float32)
    want = prepare_inference_params(state_dict_from_jax(variables),
                                    layers=layers, dtype=torch.float32,
                                    device="cpu")

    def close(a, b, path):
        assert type(a) is type(b), path
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                close(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (u, v) in enumerate(zip(a, b)):
                close(u, v, f"{path}[{i}]")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=path)

    close(got, want, "")
