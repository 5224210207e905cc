"""The port's MRLA-base family against the JAX package: the eq. 6 ops and
LA (eq. 4), the resnet50_mrlab / mrlab22 / la_eq4 models, and the mrlab
serving engine in both cache forms.

Inputs are made with seeded numpy and handed to both packages.  One init
feeds both: Flax variables go to the port through ``state_dict_from_jax``
and come back unchanged through the JAX package's
``convert_mrla_base_state_dict``.  The BN statistics are moved and the bn3
and bn_mrla scales drawn from U(0.1, 0.5), so that BN folding, every
residual branch and the cross-layer term reach the logits.  Tolerances:
the ops as ``tests/test_torch_ops.py`` (rtol 1e-5, atol 1e-6, fp32);
models and engines as the JAX package's serving tests (rtol 2e-3, atol
3e-4, fp32).  Where the JAX engine's microbatch chains are bitwise equal to
its unsplit forward, so are the port's on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ckpt import convert_mrla_base_state_dict
from mrla_tpu.models.resnet_la_eq4 import ResNetLAEq4 as FlaxLAEq4
from mrla_tpu.models.resnet_mrla_base import ResNetMRLABase as FlaxMRLABase
from mrla_tpu.ops import mrla as jops
from mrla_tpu.serving import (
    prepare_mrlab_inference_params as j_prepare,
    resnet_mrlab_forward as j_forward,
)
from mrla_tpu_torch import ops as tops
from mrla_tpu_torch.ckpt import (
    mrlab_serving_params_from_jax,
    state_dict_from_jax,
)
from mrla_tpu_torch.kernels import fused_epilogue, mrla_block_tail_fused_next
from mrla_tpu_torch.models import (
    ResNetLAEq4,
    ResNetMRLABase,
    create_model,
    list_models,
)
from mrla_tpu_torch.serving import (
    prepare_mrlab_inference_params,
    resnet_mrlab_forward,
)
import mrla_tpu_torch.serving.resnet_mrlab as engine
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
RTOL, ATOL = 2e-3, 3e-4

# kind -> (Flax class, port class, constructor arguments, layers)
KINDS = {
    "mrlab": (FlaxMRLABase, ResNetMRLABase, {}, (2, 2, 2, 2)),
    "mrlab22": (FlaxMRLABase, ResNetMRLABase,
                {"deep_stem": False, "relu_on_attn": False}, (1, 2, 1, 1)),
    "la_eq4": (FlaxLAEq4, ResNetLAEq4, {}, (1, 2, 1, 1)),
}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(rng, c):
    """(port MRLAParams, JAX MRLAParams) of one layer, k = 5 taps."""
    wq, wk = _rand(rng, 5, scale=0.5), _rand(rng, 5, scale=0.5)
    wv = _rand(rng, c, 1, 3, 3, scale=0.3)
    return (tops.MRLAParams(torch.from_numpy(wq).reshape(1, 1, 5),
                            torch.from_numpy(wk).reshape(1, 1, 5),
                            torch.from_numpy(wv)),
            jops.MRLAParams(jnp.asarray(wq), jnp.asarray(wk),
                            jnp.asarray(wv.transpose(2, 3, 1, 0))))


def _close(got, want, rtol=OPS_RTOL, atol=OPS_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape,heads,layers", [((2, 5, 5, 32), 2, 4),
                                                ((3, 7, 6, 64), 4, 3)])
def test_mrla_base_attention_matches_jax(shape, heads, layers):
    """The growing form, layer by layer, out and cache; the port's cache
    grows in place in buffers allocated once for the stage."""
    rng = np.random.default_rng(0)
    cache, jcache = None, None
    for t in range(layers):
        x = _rand(rng, *shape)
        p, jp = _params(rng, shape[-1])
        got, cache = tops.mrla_base_attention(torch.from_numpy(x), p, heads,
                                              cache, max_t=layers)
        want, jcache = jops.mrla_base_attention(jnp.asarray(x), jp, heads,
                                                jcache)
        _close(got, want)
        if t == 0:
            storage = cache.v.untyped_storage().data_ptr()
        assert cache.v.untyped_storage().data_ptr() == storage
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


def test_mrla_base_attention_concatenates_a_cache_without_room():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_rand(rng, 2, 4, 4, 16))
    p, _ = _params(rng, 16)
    out, cache = tops.mrla_base_attention(x, p, 2, None)  # room for one
    again, grown = tops.mrla_base_attention(x, p, 2, cache)
    assert grown.v.shape == (2, 2, 4, 4, 16)
    assert grown.v.untyped_storage().data_ptr() != \
        cache.v.untyped_storage().data_ptr()
    torch.testing.assert_close(grown.v[:, 0], cache.v[:, 0], rtol=0, atol=0)
    # the same layer twice: two equal logits, so the same output
    torch.testing.assert_close(again, out)


@pytest.mark.parametrize("fill", [0.0, float("nan")])
def test_fixed_form_matches_jax_and_the_growing_form_at_every_t(fill):
    """The masked fixed-length form against the JAX one (which starts from
    zeroed buffers) and against the growing form at every t; whatever the
    unwritten slots hold never reaches the output."""
    rng = np.random.default_rng(2)
    b, h, w, c, heads, t_max = 2, 5, 4, 32, 4, 4
    k_buf, v_buf = tops.cache_buffers(b, t_max, h, w, c, torch.float32,
                                      "cpu")
    k_buf.fill_(fill)
    v_buf.fill_(fill)
    jk = jnp.zeros((b, t_max, c))
    jv = jnp.zeros((b, t_max, h, w, c))
    cache = None
    for t in range(t_max):
        x = _rand(rng, b, h, w, c)
        p, jp = _params(rng, c)
        got, k_buf, v_buf = tops.mrla_base_attention_fixed(
            torch.from_numpy(x), p, heads, k_buf, v_buf, t)
        want, jk, jv = jops.mrla_base_attention_fixed(
            jnp.asarray(x), jp, heads, jk, jv, jnp.int32(t))
        grown, cache = tops.mrla_base_attention(torch.from_numpy(x), p,
                                                heads, cache)
        _close(got, want)
        _close(got, grown)
    _close(k_buf, jk)
    _close(v_buf, jv)


def test_la_eq4_attention_matches_jax():
    rng = np.random.default_rng(4)
    x, ctx = _rand(rng, 2, 4, 4, 16), _rand(rng, 2, 3, 4, 4, 16)
    p, jp = _params(rng, 16)
    _close(tops.la_eq4_attention(torch.from_numpy(x), torch.from_numpy(ctx),
                                 p, 4),
           jops.la_eq4_attention(jnp.asarray(x), jnp.asarray(ctx), jp, 4))


def _spread(port, seed):
    """``port`` with bn3 and bn_mrla scales from U(0.1, 0.5) and every BN's
    statistics averaged over 4 seeded 64 px images, so that BN folding,
    every residual branch and the cross-layer term reach the logits."""
    gen = torch.Generator().manual_seed(seed)
    bns = [(n, m) for n, m in port.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for name, bn in bns:
            if name.endswith(("bn3", "bn_mrla")):
                bn.weight.uniform_(0.1, 0.5, generator=gen)
            bn.reset_running_stats()
            bn.momentum = None
        port.train()(torch.randn(4, 64, 64, 3, generator=gen))
    return port.eval()


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


@pytest.fixture(scope="module")
def flax_case():
    """kind -> (Flax model, variables, images, Flax logits), made once for
    the module: the port's seeded init spread by ``_spread``, taken to Flax
    by the JAX package's ``convert_mrla_base_state_dict``."""
    cache = {}

    def get(kind):
        if kind not in cache:
            flax_cls, port_cls, kw, layers = KINDS[kind]
            gen = torch.Generator().manual_seed(3)
            port = _spread(port_cls(list(layers), num_classes=10, **kw,
                                    generator=gen), 3)
            variables = convert_mrla_base_state_dict(
                {k: v.numpy() for k, v in port.state_dict().items()})
            model = flax_cls(layers=list(layers), num_classes=10, **kw)
            x = _rand(np.random.default_rng(3), 2, 64, 64, 3)
            want = np.asarray(jax.jit(
                lambda v, x: model.apply(v, x, train=False))(
                    jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
            assert want.std(0).mean() > 0.05  # logits that differ by image
            cache[kind] = (model, variables, x, want)
        return cache[kind]

    return get


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_flax_through_the_weight_bridge(kind, flax_case):
    _, port_cls, kw, layers = KINDS[kind]
    _, variables, x, want = flax_case(kind)
    sd = state_dict_from_jax(variables)
    # the round trip: the JAX package's converter gives the variables back
    _assert_trees_equal(convert_mrla_base_state_dict(
        {k: v.numpy() for k, v in sd.items()}), variables)
    port = port_cls(list(layers), num_classes=10, **kw)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["mrlab", "la_eq4"])
def test_state_dict_from_jax_of_a_flax_init(kind):
    """A Flax init goes to the port's keys and back unchanged."""
    flax_cls, port_cls, kw, _ = KINDS[kind]
    model = flax_cls(layers=[1, 1, 1, 1], num_classes=10, **kw)
    variables = jax.device_get(jax.jit(
        lambda key: model.init(key, jnp.zeros((1, 32, 32, 3)),
                               train=False))(jax.random.key(4)))
    sd = state_dict_from_jax(variables)
    _assert_trees_equal(convert_mrla_base_state_dict(
        {k: v.numpy() for k, v in sd.items()}), variables)
    port_cls([1, 1, 1, 1], num_classes=10, **kw).load_state_dict(
        sd, strict=True)


@pytest.mark.parametrize("kind,use_scan", [("mrlab", False), ("mrlab", True),
                                           ("mrlab22", False)])
def test_engine_matches_the_jax_engine(kind, use_scan, flax_case):
    """resnet_mrlab_forward in fp32 against the JAX engine and Flax; no
    kernel of the port is called."""
    _, _, kw, layers = KINDS[kind]
    _, variables, x, want_flax = flax_case(kind)
    deep = kw.get("deep_stem", True)
    relu = kw.get("relu_on_attn", True)
    want = np.asarray(j_forward(
        j_prepare(variables, layers=layers, dtype=jnp.float32,
                  deep_stem=deep),
        jnp.asarray(x), layers=layers, relu_on_attn=relu, use_scan=use_scan))
    sp = prepare_mrlab_inference_params(state_dict_from_jax(variables),
                                        layers=layers, dtype=torch.float32,
                                        device="cpu", deep_stem=deep)
    fused_epilogue.counter.reset()
    mrla_block_tail_fused_next.counter.reset()
    got = resnet_mrlab_forward(sp, torch.from_numpy(x), layers=layers,
                               relu_on_attn=relu, use_scan=use_scan).numpy()
    assert fused_epilogue.counter.calls == 0
    assert mrla_block_tail_fused_next.counter.calls == 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_flax, rtol=RTOL, atol=ATOL)


def test_serving_params_from_jax_are_the_ports_own(flax_case):
    _, variables, x, _ = flax_case("mrlab")
    layers = KINDS["mrlab"][3]
    tree = jax.device_get(j_prepare(variables, layers=layers,
                                    dtype=jnp.float32))
    got = mrlab_serving_params_from_jax(tree, device="cpu",
                                        dtype=torch.float32)
    want = prepare_mrlab_inference_params(state_dict_from_jax(variables),
                                          layers=layers, dtype=torch.float32,
                                          device="cpu")
    assert [len(s) for s in got["stages"]] == list(layers)
    flat = lambda sp: [("stem", i, k, s[k]) for i, s in enumerate(sp["stem"])
                       for k in sorted(s)] + [
        ("stages", si, bi, k, blk[k]) for si, s in enumerate(sp["stages"])
        for bi, blk in enumerate(s) for k in sorted(blk)] + [
        ("fc", k, sp["fc"][k]) for k in sorted(sp["fc"])]
    for g, w in zip(flat(got), flat(want), strict=True):
        assert g[:-1] == w[:-1]
        assert (g[-1].shape, g[-1].dtype) == (w[-1].shape, w[-1].dtype)
        torch.testing.assert_close(g[-1], w[-1], rtol=1e-6, atol=1e-7)


def test_engine_allocates_a_stage_cache_once(monkeypatch, flax_case):
    """One pair of buffers a stage in either form; the masked form reads
    no unwritten slot (buffers filled with NaN give finite logits)."""
    _, variables, x, want = flax_case("mrlab")
    layers = KINDS["mrlab"][3]
    sp = prepare_mrlab_inference_params(state_dict_from_jax(variables),
                                        layers=layers, dtype=torch.float32,
                                        device="cpu")
    made = []

    def nan_buffers(*args):
        bufs = tops.cache_buffers(*args)
        made.append(args)
        return tuple(b.fill_(float("nan")) for b in bufs)

    monkeypatch.setattr(engine, "cache_buffers", nan_buffers)
    for use_scan in (False, True):
        made.clear()
        got = resnet_mrlab_forward(sp, torch.from_numpy(x), layers=layers,
                                   use_scan=use_scan)
        assert [a[1] for a in made] == list(layers)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_microbatch_chains_bitwise_equal():
    model = create_model("resnet50_mrlab", device="cpu", num_classes=10,
                         generator=torch.Generator().manual_seed(6))
    sp = prepare_mrlab_inference_params(model, dtype=torch.float32,
                                        device="cpu")
    x = torch.from_numpy(_rand(np.random.default_rng(6), 8, 32, 32, 3))
    full = resnet_mrlab_forward(sp, x)
    for use_scan in (False, True):
        split = resnet_mrlab_forward(sp, x, microbatch=2, use_scan=use_scan)
        assert torch.equal(full, split)
    # a microbatch that does not divide the batch serves it unsplit
    assert torch.equal(full, resnet_mrlab_forward(sp, x, microbatch=3))


def test_prepare_guards_the_layer_set():
    sd = ResNetMRLABase([1, 1, 1, 1], num_classes=10).state_dict()
    with pytest.raises(ValueError, match="does not match"):
        prepare_mrlab_inference_params(sd, layers=(1, 2, 1, 1), device="cpu")


def test_entry_points_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sd = ResNetMRLABase([1, 1, 1, 1], num_classes=10).state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_mrlab_inference_params(sd, layers=(1, 1, 1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("resnet50_mrlab", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mrlab_serving_params_from_jax({"stem": [], "stages": [],
                                       "fc": {"k": np.zeros((2, 2)),
                                              "b": np.zeros(2)}})


def test_features_only_serves_the_stage_maps():
    gen = torch.Generator().manual_seed(9)
    full = ResNetMRLABase([1, 2, 1, 1], num_classes=10, generator=gen).eval()
    trunk = ResNetMRLABase([1, 2, 1, 1], features_only=True).eval()
    sd = {k: v for k, v in full.state_dict().items()
          if not k.startswith("fc.")}
    trunk.load_state_dict(sd, strict=True)
    x = torch.from_numpy(_rand(np.random.default_rng(9), 2, 64, 64, 3))
    with torch.no_grad():
        maps = trunk(x)
        logits = full(x)
    assert [tuple(m.shape) for m in maps] == [
        (2, 16, 16, 256), (2, 8, 8, 512), (2, 4, 4, 1024), (2, 2, 2, 2048)]
    torch.testing.assert_close(full.fc(maps[-1].mean(dim=(1, 2))), logits)


def test_channel_gates_are_not_ported_yet():
    """The SE / ECA gates are ported now (their parity with Flax is in
    tests/test_torch_resnet_family.py): the models build them after bn3,
    and the BN-folding engine, which has no gate to fold, refuses them."""
    from mrla_tpu_torch.nn import ECALayer, SELayer

    se = ResNetMRLABase([1, 1, 1, 1], se=True)
    eca = ResNetMRLABase([1, 1, 1, 1], eca=(5, 5, 5, 7))
    assert isinstance(se.layer1[0].se, SELayer)
    assert [b.eca.conv.weight.numel() for s in (eca.layer1, eca.layer4)
            for b in s] == [5, 7]
    with pytest.raises(ValueError, match="SE / ECA"):
        prepare_mrlab_inference_params(se, (1, 1, 1, 1), device="cpu")


# arch -> (blocks per stage, deep stem, ReLU on attn, heads of the last
# stage's MRLA layer or None for LA)
ARCHS = {
    "resnet50_mrlab": ((3, 4, 6, 3), True, True, 128),
    "resnet101_mrlab": ((3, 4, 23, 3), True, True, 128),
    "resnet152_mrlab": ((3, 8, 36, 3), True, True, 128),
    "resnet50_mrlab22": ((3, 4, 6, 3), False, False, 128),
    "resnet50_la_eq4": ((3, 4, 6, 3), False, None, 64),
    "resnet101_la_eq4": ((3, 4, 23, 3), False, None, 64),
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_registered_archs_build_and_serve_a_forward(arch):
    """Each arch from the registry at its published depth and widths, on
    the CPU: its structure, and a forward on two 32 px images."""
    layers, deep, relu, heads = ARCHS[arch]
    assert arch in list_models()
    model = create_model(arch, device="cpu", num_classes=10,
                         generator=torch.Generator().manual_seed(8)).eval()
    assert tuple(len(getattr(model, f"layer{s + 1}"))
                 for s in range(4)) == layers
    assert isinstance(model.conv1, torch.nn.Sequential) == deep
    last = model.layer4[-1]
    if relu is None:
        assert last.la.heads == heads and hasattr(last, "bn_la")
    else:
        assert last.relu_on_attn == relu and last.mrla.mrla.heads == heads
        assert not hasattr(last.mrla, "lambda_t")
    with torch.no_grad():
        out = model(torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 10) and torch.isfinite(out).all()


# ----------------------------------------- the training options (item 5a)

# kind -> (Flax class, port class, options, layers, RNG collections)
OPTION_KINDS = {
    "mrlab": (FlaxMRLABase, ResNetMRLABase,
              dict(groups=2, width_per_group=32, drop_path=0.3,
                   drop_rate=0.2), (1, 2, 1, 1)),
    "la_eq4": (FlaxLAEq4, ResNetLAEq4,
               dict(se=True, eca=(3, 3, 5, 5), groups=2, width_per_group=32,
                    drop_rate=0.2), (1, 2, 1, 1)),
}


def _flax_train_forward(model, variables, x):
    """Flax's train forward (logits, batch_stats) and the keep masks its
    DropPath and Dropout draw, in the order drawn: ``jax.random.bernoulli``
    recorded while the forward traces, the masks returned from the jit."""
    masks, real = [], jax.random.bernoulli

    def record(*a, **kw):
        masks.append(real(*a, **kw))
        return masks[-1]

    def fwd(v, x):
        masks.clear()
        out, mut = model.apply(v, x, train=True, mutable=["batch_stats"],
                               rngs={"droppath": jax.random.key(1),
                                     "dropout": jax.random.key(2)})
        return out, mut["batch_stats"], list(masks)

    jax.random.bernoulli = record
    try:
        return jax.jit(fwd)(jax.tree.map(jnp.asarray, variables),
                            jnp.asarray(x))
    finally:
        jax.random.bernoulli = real


@pytest.mark.parametrize("kind", list(OPTION_KINDS))
def test_train_forward_with_the_options_matches_flax(kind, monkeypatch):
    """mrlab with groups, width_per_group, DropPath on the attention branch
    and dropout before fc; la_eq4 with SE, ECA, groups, width_per_group and
    dropout: the train forward's logits and BN statistics against Flax's,
    the port's masks the ones Flax draws (each module's in call order)."""
    from mrla_tpu_torch.models.common import BatchNorm2d
    from mrla_tpu_torch.ops import drop

    flax_cls, port_cls, kw, layers = OPTION_KINDS[kind]
    port = port_cls(list(layers), num_classes=10, **kw,
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for name, m in port.named_modules():
            if isinstance(m, BatchNorm2d) and name.endswith(("bn3",
                                                             "bn_mrla")):
                m.weight.uniform_(0.1, 0.5)
    sd = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    variables = convert_mrla_base_state_dict(sd)
    x = _rand(np.random.default_rng(5), 4, 32, 32, 3)
    want, stats, masks = _flax_train_forward(
        flax_cls(layers=list(layers), num_classes=10, **kw), variables, x)
    n_drop = sum(layers) if "drop_path" in kw else 0
    assert len(masks) == n_drop + 1  # DropPath a block, then the head
    assert any(not np.asarray(m).all() for m in masks)  # something drops
    queue = [torch.from_numpy(np.array(m)) for m in masks]

    def jax_mask(x, rate, shape, generator, what):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape), what
        return torch.where(mask, x / (1.0 - rate), torch.zeros((),
                                                                dtype=x.dtype))

    monkeypatch.setattr(drop, "_masked", jax_mask)
    got = port.train()(torch.from_numpy(x))
    assert not queue
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    j_sd = state_dict_from_jax({"params": variables["params"],
                                "batch_stats": jax.device_get(stats)})
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), j_sd[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_bridge_carries_la_eq4_with_se_and_eca():
    """la_eq4 with SE and ECA: its state_dict goes to Flax (the JAX
    package's converter) and back through the bridge unchanged, the gates'
    ``se.fc.{0,2}`` and ``eca.conv`` included."""
    kw = dict(se=True, eca=(3, 3, 5, 5))
    port = ResNetLAEq4([1, 1, 1, 1], num_classes=10, **kw,
                       generator=torch.Generator().manual_seed(4))
    sd = port.state_dict()
    variables = convert_mrla_base_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert "se" in variables["params"]["layer4_0"]
    assert "eca" in variables["params"]["layer4_0"]
    back = state_dict_from_jax(variables)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert back["layer4.0.se.fc.0.weight"].shape == (128, 2048)
    assert back["layer4.0.eca.conv.weight"].shape == (1, 1, 5)


def test_cli_trains_resnet50_mrlab_with_drop_path_and_dropout(tmp_path):
    """The trainer builds resnet50_mrlab (full depth: --layers takes no
    mrlab arch) with --drop-path and --drop-rate and takes a step."""
    from mrla_tpu_torch.nn.layers import DropPath, Dropout
    from mrla_tpu_torch.train import cli

    res = cli.main(["-a", "resnet50_mrlab", "--drop-path", "0.1",
                    "--drop-rate", "0.1", "--image-size", "32", "-b", "2",
                    "--num-classes", "3", "--epochs", "1",
                    "--synthetic-steps", "1", "--device", "cpu",
                    "--output-dir", str(tmp_path)])
    assert len(res["loss"]) == 1 and np.isfinite(res["loss"]).all()
    model = res["state"].model
    assert {m.rate for m in model.modules()
            if isinstance(m, DropPath)} == {0.1}
    assert model.head_drop.p == 0.1 and isinstance(model.head_drop, Dropout)
