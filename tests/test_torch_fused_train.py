"""The port's fused MRLA-light train epilogue (``ops/fused_train.py``)
against the JAX op (``mrla_tpu/ops/fused_train.py``): forward and VJP, then
against autograd through the port's own composition, and the fused model's
train step against the unfused one.  Tolerances are the JAX package's
``tests/test_fused_train.py``: the forward ``rtol/atol 1e-5`` (mean
``rtol 1e-6``, var ``rtol 1e-5, atol 1e-7``), the gradients ``2e-4``, the
model step's loss ``rtol 1e-5``, parameters ``rtol 5e-4, atol 5e-5`` and
running statistics ``rtol 1e-4, atol 1e-5``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrla_tpu.ops.fused_train import (
    fused_light_epilogue_train as j_fused,
)
from mrla_tpu_torch.models import ResNetMRLALight
from mrla_tpu_torch.ops import MRLAParams
from mrla_tpu_torch.ops.fused_train import (
    fused_epilogue_module_equivalent,
    fused_light_epilogue_train,
)
from mrla_tpu_torch.train import create_train_state, train_step
from mrla_tpu_torch.train.optim import sgd_torch

NAMES = ["out", "identity", "wq", "wk", "wv", "lam", "scale", "bias"]


def _op_inputs(seed=0, b=2, h=8, w=8, c=32, heads=2):
    """numpy inputs in the JAX layouts (wv [3, 3, 1, C])."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [np.maximum(f(b, h, w, c), 0), f(b, h, w, c), f(3) * 0.3,
            f(3) * 0.3, f(3, 3, 1, c) * 0.3, f(c) * 0.5, f(c) * 0.2 + 1.0,
            f(c) * 0.2], heads


def _port_args(args):
    """The same inputs as torch tensors in the port's layouts (wv
    [C, 1, 3, 3]), each a leaf that wants its gradient."""
    out = [torch.from_numpy(np.ascontiguousarray(
        a.transpose(3, 2, 0, 1) if n == "wv" else a)) for n, a in
        zip(NAMES, args)]
    return [t.requires_grad_() for t in out]


def _loss(ret, mean, var):
    # touch all three outputs so every cotangent path is exercised
    return (ret ** 2).sum() + (mean * 0.1).sum() + (var * 0.05).sum()


def test_fused_op_forward_matches_jax():
    args, heads = _op_inputs()
    ret, mean, var = fused_light_epilogue_train(*_port_args(args), heads)
    j_ret, j_mean, j_var = j_fused(*map(jnp.asarray, args), heads)
    np.testing.assert_allclose(ret.detach().numpy(), np.asarray(j_ret),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(j_mean),
                               rtol=1e-6)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(j_var),
                               rtol=1e-5, atol=1e-7)


def test_fused_op_vjp_matches_jax():
    args, heads = _op_inputs(1)
    t_args = _port_args(args)
    _loss(*fused_light_epilogue_train(*t_args, heads)).backward()
    want = jax.grad(lambda a: _loss(*j_fused(*a, heads)))(
        tuple(map(jnp.asarray, args)))
    for n, t, w in zip(NAMES, t_args, want):
        w = np.asarray(w)
        if n == "wv":
            w = w.transpose(3, 2, 0, 1)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"grad mismatch for {n}")


def test_fused_op_matches_autograd_through_the_composition():
    args, heads = _op_inputs(2, c=64, heads=4)
    fused, plain = _port_args(args), _port_args(args)
    got = fused_light_epilogue_train(*fused, heads)
    o, i, q, k, v, lam, s, b = plain
    want = fused_epilogue_module_equivalent(o, i, MRLAParams(q, k, v), lam,
                                            s, b, heads)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    _loss(*got).backward()
    _loss(*want).backward()
    for n, a, w in zip(NAMES, fused, plain):
        torch.testing.assert_close(a.grad, w.grad, rtol=2e-4, atol=2e-4,
                                   msg=f"grad mismatch for {n}")


def _model(fused, seed=0):
    """resnet_mrlal [1, 1] with bn3 scales drawn from U(0.1, 0.5), so that
    every residual branch works."""
    gen = torch.Generator().manual_seed(seed)
    model = ResNetMRLALight([1, 1], num_classes=10, generator=gen,
                            fused_epilogue=fused)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith("bn3"):
                m.weight.uniform_(0.1, 0.5, generator=gen)
    return model


def test_fused_model_train_step_matches_unfused():
    """Same init, one SGD step: the same loss, parameters and running
    statistics."""
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(
                 rng.standard_normal((4, 32, 32, 3)).astype(np.float32)),
             "label": torch.arange(4) % 10}
    out = {}
    for fused in (False, True):
        model = _model(fused)
        state = create_train_state(
            model, sgd_torch(model.parameters(), 0.05, 0.9), lambda s: 0.05)
        loss = train_step(state, batch)["loss"]
        out[fused] = (float(loss), model.state_dict())
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    ref = out[False][1]
    for k, v in out[True][1].items():
        tol = ((1e-4, 1e-5) if "running" in k else (5e-4, 5e-5))
        torch.testing.assert_close(v, ref[k], rtol=tol[0], atol=tol[1],
                                   msg=k)


@pytest.mark.parametrize("mode", ["eval", "train_with_drop_path"])
def test_fused_model_takes_the_module_path_otherwise(mode):
    """fused_epilogue changes nothing in eval mode (bitwise), nor in
    training while DropPath is active (the fused tail is not taken)."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    outs = []
    for fused in (False, True):
        model = _model(fused)
        if mode == "eval":
            model.eval()
        else:
            for blk in (model.layer1[0], model.layer2[0]):
                blk.drop_path.rate = 0.5
                blk.drop_path.generator = torch.Generator().manual_seed(5)
        outs.append(model(x))
    assert torch.equal(outs[0], outs[1])
