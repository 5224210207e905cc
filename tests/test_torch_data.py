"""The port's real-data source against the JAX package's: the ImageFolder
loader's uint8 batches bit for bit (a PNG tree through PIL; a JPEG tree
through the native loader, bilinear, and PIL, bicubic; train and eval with
a ragged eval batch) and the decoder each batch names; the samplers; the
CIFAR and iNat readers; the native ``decode_batch`` with missing and
corrupt files; then the trainer on an ImageFolder tree on the CPU
(``--data``, ``--repeated-aug``, ``--profile-dir``) and ``eval_step``'s
counts of a padded batch against ``make_eval_step`` on the same weights.
Trees are written as ``tests/test_data.py`` and
``tests/test_native_loader.py`` write theirs."""

import glob
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrla_tpu import data as j_data
from mrla_tpu.data import cifar as j_cifar
from mrla_tpu.data import inat as j_inat
from mrla_tpu.data import native as j_native
from mrla_tpu.models.resnet_mrla_light import ResNetMRLALight as FlaxResNet
from mrla_tpu.train import create_train_state as j_create_train_state
from mrla_tpu.train import make_eval_step
from mrla_tpu_torch import data
from mrla_tpu_torch.ckpt import arch_state_dict_from_jax
from mrla_tpu_torch.data import cifar, inat, native
from mrla_tpu_torch.models import ResNetMRLALight
from mrla_tpu_torch.train import cli
from mrla_tpu_torch.train.state import create_train_state
from mrla_tpu_torch.train.steps import eval_step
from tests.test_cifar_distill import _write_fake_cifar100
from tests.test_inat import _write_fixture
from tests.test_torch_resnet_family import numpy_variables
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

SIZES = [(40, 50), (60, 48), (37, 64), (48, 48)]


def _write_tree(root, ext, classes=2, per_class=(4, 3), seed=0):
    """Noise images of mixed sizes under root/class_<c>/."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class[c % len(per_class)]):
            h, w = SIZES[(c + i) % len(SIZES)]
            arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img{i}{ext}"),
                                      quality=95)
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    return {ext: _write_tree(base / ext.strip("."), ext)
            for ext in (".png", ".jpg")}


@pytest.mark.parametrize("ext,interpolation,decoder", [
    (".png", "bilinear", "pil"), (".jpg", "bilinear", "native"),
    (".jpg", "bicubic", "pil")])
@pytest.mark.parametrize("train", [True, False])
def test_iterate_batches_bitwise_the_jax_loader(trees, ext, interpolation,
                                                decoder, train):
    root = trees[ext]
    ds, j_ds = data.ImageFolder(root), j_data.ImageFolder(root)
    assert ds.samples == j_ds.samples
    assert ds.class_to_idx == j_ds.class_to_idx
    idx = np.random.default_rng(1).permutation(len(ds))  # 7: ragged at 3
    kw = dict(batch_size=3, size=32, train=train, seed=5, num_threads=2,
              interpolation=interpolation)
    got = list(data.iterate_batches(ds, idx, **kw))
    want = list(j_data.iterate_batches(j_ds, idx, **kw))
    assert [len(b["label"]) for b in got] == ([3, 3] if train
                                              else [3, 3, 1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["decoder"] == decoder
        assert g["image"].dtype == np.uint8
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_iterate_batches_raises_a_workers_error(tmp_path):
    root = _write_tree(tmp_path, ".png")
    with open(os.path.join(root, "class_0", "img1.png"), "wb") as f:
        f.write(b"not an image")
    ds = data.ImageFolder(root)
    with pytest.raises(Exception, match="img1.png|identify"):
        list(data.iterate_batches(ds, np.arange(len(ds)), 2, size=16,
                                  num_threads=2))


def test_imagefolder_refuses_a_tree_without_classes(tmp_path):
    with pytest.raises(FileNotFoundError, match="no class directories"):
        data.ImageFolder(str(tmp_path))


@pytest.mark.parametrize("n,world", [(103, 4), (3, 8), (1, 4), (0, 4),
                                     (16, 1)])
def test_distributed_indices_as_jax(n, world):
    for rank in range(world):
        for shuffle in (True, False):
            np.testing.assert_array_equal(
                data.distributed_indices(n, rank, world, 2, shuffle, 7),
                j_data.distributed_indices(n, rank, world, 2, shuffle, 7))


@pytest.mark.parametrize("n,world", [(1024, 4), (1000, 4), (1000, 1),
                                     (300, 8), (5, 8), (0, 2)])
def test_ra_sampler_indices_as_jax(n, world):
    for rank in range(world):
        got = data.ra_sampler_indices(n, rank, world, 3, seed=11)
        np.testing.assert_array_equal(
            got, j_data.ra_sampler_indices(n, rank, world, 3, seed=11))
        assert len(got) == n // 256 * 256 // world


def _write_fake_cifar10(root):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(1)
    for name, n in [*((f"data_batch_{i}", 8) for i in range(1, 6)),
                    ("test_batch", 6)]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 255, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, n))}, f)


@pytest.mark.parametrize("variant", ["cifar100", "cifar10"])
@pytest.mark.parametrize("train", [True, False])
def test_cifar_as_jax(tmp_path, variant, train):
    _write_fake_cifar100(str(tmp_path))
    _write_fake_cifar10(str(tmp_path))
    ds = cifar.CIFAR(str(tmp_path), train=train, variant=variant)
    j_ds = j_cifar.CIFAR(str(tmp_path), train=train, variant=variant)
    np.testing.assert_array_equal(ds.images, j_ds.images)
    np.testing.assert_array_equal(ds.labels, j_ds.labels)
    assert ds.images.dtype == np.uint8 and ds.labels.dtype == np.int32
    assert ds.num_classes == j_ds.num_classes
    idx = np.random.default_rng(0).permutation(len(ds))
    for drop_last in (True, False):
        got = list(cifar.iterate_cifar(ds, idx, 5, drop_last))
        want = list(j_cifar.iterate_cifar(j_ds, idx, 5, drop_last))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("image", "label"):
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError):
        cifar.CIFAR(str(tmp_path), variant="cifar7")


@pytest.mark.parametrize("category", ["name", "family"])
def test_inat_as_jax(tmp_path, category):
    _write_fixture(str(tmp_path))
    for train in (True, False):
        ds = inat.INatDataset(str(tmp_path), train=train, category=category)
        j_ds = j_inat.INatDataset(str(tmp_path), train=train,
                                  category=category)
        assert ds.samples == j_ds.samples
        assert ds.num_classes == j_ds.num_classes


def test_native_decode_batch_bitwise_jax_with_bad_files(trees, tmp_path):
    assert native.available(), native.build_error()
    assert j_native.available()
    paths = sorted(glob.glob(os.path.join(trees[".jpg"], "*", "*.jpg")))
    bad_header = tmp_path / "bad_header.jpg"
    bad_header.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    good = open(paths[0], "rb").read()
    truncated = tmp_path / "trunc.jpg"
    truncated.write_bytes(good[:len(good) // 3])
    paths = [paths[0], str(tmp_path / "missing.jpg"), str(bad_header),
             *paths[1:], str(truncated)]
    for train in (True, False):
        with pytest.warns(UserWarning, match="decoded 8/10"):
            got = native.decode_batch(paths, 24, train=train, seed=9,
                                      num_threads=3)
        with pytest.warns(UserWarning):
            want = j_native.decode_batch(paths, 24, train=train, seed=9,
                                         num_threads=3)
        np.testing.assert_array_equal(got, want)
        assert got[1].sum() == 0 and got[2].sum() == 0
        assert got[0].sum() > 0 and got[3].sum() > 0


def test_native_build_error_is_kept(tmp_path, monkeypatch):
    broken = tmp_path / "loader.cc"
    broken.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert "no_such_header_here.h" in native.build_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode_batch(["x.jpg"], 8, train=False)


def _cli_args(root, out, *extra):
    return ["-a", "resnet50_mrlal", "--layers", "1", "1", "1", "1",
            "--data", root, "--image-size", "32", "--num-classes", "2",
            "-b", "3", "--epochs", "1", "--workers", "2", "--device", "cpu",
            "--output-dir", str(out), *extra]


def test_cli_trains_on_an_imagefolder_and_counts_each_val_image(tmp_path):
    root = tmp_path / "tree"
    _write_tree(root / "train", ".jpg", per_class=(4, 3))
    _write_tree(root / "val", ".jpg", per_class=(3, 2), seed=1)
    res = cli.main(_cli_args(str(root), tmp_path / "run",
                             "--random-erase", "0.5", "--label-smooth",
                             "0.1"))
    assert len(res["loss"]) == 7 // 3 and np.isfinite(res["loss"]).all()
    assert res["val_count"] == 5  # two batches of 3, the last padded
    assert res["decoders"] == {"train": ["native"] * 2,
                               "val": ["native"] * 2}
    assert len(res["data_s"]) == len(res["step_s"]) == 2
    ev = cli.main(_cli_args(str(root), tmp_path / "run", "-e", "--resume",
                            str(tmp_path / "run")))
    assert ev["val_count"] == 5 and ev["acc1"] == res["history"][0]["acc1"]
    # the DeiT recipe resamples bicubically: PIL
    deit = cli.main(["-a", "deit_tiny_patch16_224", "--data", str(root),
                     "--image-size", "32", "--num-classes", "2", "-b", "3",
                     "--epochs", "1", "--workers", "2", "--opt", "adamw",
                     "--lr", "1e-3", "--mixup", "0.8", "--cutmix", "1.0",
                     "--device", "cpu", "--output-dir",
                     str(tmp_path / "deit")])
    assert deit["decoders"]["train"] == ["pil"] * 2
    assert deit["val_count"] == 5


def test_cli_repeated_aug_and_profile_dir(tmp_path, monkeypatch):
    root = tmp_path / "tree"
    _write_tree(root / "train", ".png", classes=16, per_class=(16,))
    _write_tree(root / "val", ".png", per_class=(1,))
    calls = []

    def ra(*a, **kw):
        calls.append(a)
        return data.ra_sampler_indices(*a, **kw)

    monkeypatch.setattr(cli, "ra_sampler_indices", ra)
    prof = tmp_path / "prof"
    res = cli.main(_cli_args(str(root), tmp_path / "run", "--repeated-aug",
                             "-b", "40", "--image-size", "16",
                             "--num-classes", "16",
                             "--profile-dir", str(prof)))
    # 256 images, each three times, cut to 256: 6 steps of 40
    assert calls == [(256, 0, 1, 0)]
    assert len(res["loss"]) == 6 and res["val_count"] == 2
    # steps [5, 15) traced, closed where the epoch ended (after step 5)
    with open(prof / cli.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_eval_counts_of_a_padded_batch_as_jax():
    flax_model = FlaxResNet(layers=(1, 1, 1, 1), num_classes=10)
    variables = numpy_variables(flax_model, 32, seed=3)
    model = ResNetMRLALight([1, 1, 1, 1], num_classes=10)
    model.load_state_dict(arch_state_dict_from_jax("resnet50_mrlal",
                                                   variables))
    images = np.random.default_rng(0).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(images))
    # rows 0-2 labelled with their top-1, 3-4 with their third class, the
    # padding (rows 6-7) with its top-1 (counted only if not masked)
    order = logits.argsort(-1, descending=True)
    labels = np.asarray([order[i, 0] if i in (0, 1, 2, 6, 7) else
                         order[i, 2] if i in (3, 4) else order[i, 9]
                         for i in range(8)], np.int32)
    valid = np.arange(8) < 6
    state = create_train_state(model, torch.optim.SGD(model.parameters(),
                                                      0.1), lambda s: 0.1)
    got = eval_step(state, {"image": torch.from_numpy(images),
                            "label": torch.from_numpy(labels),
                            "valid": torch.from_numpy(valid)})
    j_state = j_create_train_state(flax_model, jax.random.key(0),
                                   jnp.zeros((1, 32, 32, 3)),
                                   optax.sgd(0.1), variables=variables)
    want = jax.jit(make_eval_step())(j_state, {
        "image": jnp.asarray(images), "label": jnp.asarray(labels),
        "valid": jnp.asarray(valid)})
    assert {k: int(v) for k, v in got.items()} == {
        k: int(want[k]) for k in ("top1", "top5", "count")} == {
        "top1": 3, "top5": 5, "count": 6}


def test_the_port_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    code = ("import sys, mrla_tpu_torch, mrla_tpu_torch.train.cli, "
            "mrla_tpu_torch.data.randaugment, mrla_tpu_torch.utils; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mrla_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
