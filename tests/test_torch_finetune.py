"""Fine-tuning and the distillation teacher against the JAX package:
``interpolate_pos_embed`` against the JAX function (224 -> 384 and 384 ->
224 grids, ``rtol=atol=1e-5``) and the bicubic matrix against JAX's,
``reset_classifier``'s shapes and statistics; the trainer's ``--finetune``
(a new grid, new classes, the EMA copied from the fine-tuned model before
the first step, where the JAX trainer's EMA keeps the random init) and
``--teacher-resume`` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrla_tpu.models.deit import VisionTransformer as FlaxViT
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.utils import finetune as j_finetune
from mrla_tpu_torch.ckpt import read_model_state_dict
from mrla_tpu_torch.models import create_model
from mrla_tpu_torch.train import cli
from mrla_tpu_torch.utils import finetune
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("old,new", [(14, 24), (24, 14), (14, 14)])
@pytest.mark.parametrize("extra", [1, 2])
def test_interpolate_pos_embed_as_jax(old, new, extra):
    pos = np.random.default_rng(old + extra).standard_normal(
        (1, extra + old * old, 16)).astype(np.float32)
    got = finetune.interpolate_pos_embed(torch.from_numpy(pos), new * new,
                                         extra)
    want = np.asarray(j_finetune.interpolate_pos_embed(
        jnp.asarray(pos), new * new, extra))
    assert got.shape == (1, extra + new * new, 16) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[:, :extra].numpy(), pos[:, :extra])


def test_bicubic_matrix_is_the_jax_matrix():
    for n_in, n_out in ((14, 24), (24, 14), (7, 12)):
        np.testing.assert_array_equal(
            finetune.torch_bicubic_weights(n_in, n_out),
            j_finetune._torch_bicubic_weights(n_in, n_out))


def test_reset_classifier_shapes_and_statistics():
    sd = {"head.weight": torch.ones(1000, 192), "head.bias": torch.ones(1000),
          "head_dist.weight": torch.ones(1000, 192),
          "head_dist.bias": torch.ones(1000), "norm.weight": torch.ones(192)}
    out = finetune.reset_classifier(sd, 500, torch.Generator().manual_seed(0))
    assert out["norm.weight"] is sd["norm.weight"]
    for name in ("head", "head_dist"):
        w, b = out[f"{name}.weight"], out[f"{name}.bias"]
        assert w.shape == (500, 192) and b.shape == (500,)
        assert torch.equal(b, torch.zeros(500))
        # 0.02 x a unit normal cut at +-2: std 0.02 * 0.8796
        assert abs(w.std().item() - 0.02 * 0.8796) < 2e-4
        assert w.abs().max().item() <= 0.04
    assert not torch.equal(out["head.weight"], out["head_dist.weight"])
    again = finetune.reset_classifier(sd, 500,
                                      torch.Generator().manual_seed(0))
    assert torch.equal(again["head.weight"], out["head.weight"])


def _deit(out, px, classes, *extra):
    return ["-a", "deit_tiny_distilled_patch16_224", "--data", "synthetic",
            "--image-size", str(px), "--num-classes", str(classes), "-b",
            "2", "--synthetic-steps", "1", "--opt", "adamw", "--lr", "1e-3",
            "--device", "cpu", "--output-dir", str(out), *extra]


def test_finetune_resamples_resets_and_copies_the_ema(tmp_path):
    pre = tmp_path / "pre"
    cli.main(_deit(pre, 32, 5, "--epochs", "1"))
    saved = read_model_state_dict(str(pre))
    # --epochs 0: the state as fine-tuning leaves it, before its first step
    state = cli.main(_deit(tmp_path / "ft", 48, 3, "--epochs", "0",
                           "--ema-decay", "0.99996", "--finetune",
                           str(pre)))["state"]
    got = state.model.state_dict()
    torch.testing.assert_close(
        got["pos_embed"], finetune.interpolate_pos_embed(
            saved["pos_embed"], 9, 2), rtol=0, atol=0)
    assert got["pos_embed"].shape == (1, 2 + 9, 192)
    for name in ("head", "head_dist"):
        assert got[f"{name}.weight"].shape == (3, 192)
        assert torch.equal(got[f"{name}.bias"], torch.zeros(3))
    for k, v in got.items():
        if k != "pos_embed" and not k.startswith("head"):
            assert torch.equal(v, saved[k]), k
    for k, v in state.ema.state_dict().items():  # the fine-tuned weights
        assert torch.equal(v, got[k]), k
    # and it trains from there
    res = cli.main(_deit(tmp_path / "ft", 48, 3, "--epochs", "1",
                         "--ema-decay", "0.99996", "--finetune", str(pre)))
    assert np.isfinite(res["loss"]).all()


def test_jax_trainers_finetune_ema_keeps_the_random_init():
    """The JAX trainer builds its state (EMA included) from the random init
    and then replaces params alone (``mrla_tpu/train/cli.py``'s
    ``state.replace(params=src, ...)``): its EMA does not start from the
    fine-tuned weights.  The port copies the EMA after loading."""
    model = FlaxViT(patch_size=16, embed_dim=32, depth=1, num_heads=2,
                    num_classes=3, img_size=32)
    sample = jnp.zeros((1, 32, 32, 3))
    init = jax.tree.map(  # the init's shapes, no compile
        lambda a: np.full(a.shape, 0.5, a.dtype),
        jax.eval_shape(lambda: model.init(jax.random.key(0), sample,
                                          train=False)))
    state = j_create_train_state(model, jax.random.key(0), sample,
                                 optax.sgd(0.1), ema_decay=0.99996,
                                 variables=init)
    tuned = jax.tree.map(lambda a: a + 1.0, init["params"])
    state = state.replace(params=tuned, batch_stats=state.batch_stats)
    ema, live = (jax.tree.leaves(state.ema_params),
                 jax.tree.leaves(state.params))
    assert not any(np.array_equal(e, p) for e, p in zip(ema, live))


def test_teacher_resume_loads_the_saved_model(tmp_path):
    teacher_run = tmp_path / "teacher"
    cli.main(["-a", "resnet50", "--data", "synthetic", "--image-size", "32",
              "--num-classes", "4", "-b", "2", "--synthetic-steps", "1",
              "--epochs", "1", "--device", "cpu", "--output-dir",
              str(teacher_run)])
    argv = ["-a", "deit_tiny_distilled_patch16_224", "--data", "synthetic",
            "--image-size", "32", "--num-classes", "4", "-b", "2",
            "--synthetic-steps", "1", "--epochs", "1", "--opt", "adamw",
            "--distillation-type", "hard", "--device", "cpu"]
    res = cli.main(argv + ["--teacher-resume", str(teacher_run),
                           "--output-dir", str(tmp_path / "s")])
    random_teacher = cli.main(argv + ["--output-dir",
                                      str(tmp_path / "r")])["teacher"]
    saved = create_model("resnet50", device="cpu", num_classes=4)
    saved.load_state_dict(read_model_state_dict(str(teacher_run)))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = saved.eval()(x)
        assert torch.equal(res["teacher"](x), want)
        assert not torch.allclose(random_teacher(x), want, atol=1e-3)
    with pytest.raises(FileNotFoundError, match="teacher-resume"):
        cli.main(argv + ["--teacher-resume", str(tmp_path / "none"),
                         "--output-dir", str(tmp_path / "n")])
