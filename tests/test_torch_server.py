"""The port's batching daemon (``mrla_tpu_torch/serving/server.py``): the
eleven cases of ``tests/test_server.py`` on the port's engines, and the
same npy request to the JAX package's daemon and the port's on the same
weights (fp32), within the serving tolerance of ``tests/test_serving.py``."""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mrla_tpu_torch.detect import MRLABackboneFPN
from mrla_tpu_torch.detect.retinanet import RetinaNet, get_bboxes
from mrla_tpu_torch.detect.two_stage import FasterRCNN, MaskRCNN
from mrla_tpu_torch.models import ResNetMRLALight
from mrla_tpu_torch.serving import (
    detect_forward,
    prepare_detect_params,
    prepare_inference_params,
    resnet_mrlal_forward,
    two_stage_detections,
)
from mrla_tpu_torch.serving.cli import make_engine_forward
from mrla_tpu_torch.serving.server import (
    BatchingEngine,
    _make_handler,
    build_detect_server,
    build_detections_server,
)
from tests.torch_fixtures import two_threads  # noqa: F401 (autouse)

SHAPE = (8, 8, 3)
RTOL, ATOL = 2e-3, 3e-4  # tests/test_serving.py:48


def _toy_fwd(x):
    """Deterministic per-image 'logits': channel means -> 3 classes."""
    return x.float().mean(dim=(1, 2))


def _images(n, seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32)


def _engine(fwd, batch_size, shape=SHAPE, max_wait_ms=10.0):
    return BatchingEngine(fwd, batch_size=batch_size, image_shape=shape,
                          max_wait_ms=max_wait_ms, device="cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _start_http(eng, info):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(eng, info))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, eng):
    httpd.shutdown()
    httpd.server_close()
    eng.close()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(url, body, ctype="application/x-npy", timeout=60):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_batching_pads_and_routes_rows():
    eng = _engine(_toy_fwd, 4, max_wait_ms=50.0)
    try:
        imgs = _images(5)
        pend = [eng.submit(im) for im in imgs]
        for p in pend:
            assert p.event.wait(5.0)
            assert p.error is None
        got = np.stack([p.logits for p in pend])
        np.testing.assert_allclose(got, imgs.mean(axis=(1, 2)), rtol=1e-6)
        assert eng.stats == {"requests": 5, "batches": 2, "padded_rows": 3}
    finally:
        eng.close()


def test_single_request_flushes_on_timeout():
    eng = _engine(_toy_fwd, 8)
    try:
        img = _images(1)[0]
        p = eng.submit(img)
        assert p.event.wait(5.0), "timeout flush never fired"
        np.testing.assert_allclose(p.logits, img.mean(axis=(0, 1)),
                                   rtol=1e-6)
    finally:
        eng.close()


def test_engine_error_propagates():
    def bad_fwd(x):
        raise RuntimeError("boom")

    eng = _engine(bad_fwd, 2)
    try:
        p = eng.submit(_images(1)[0])
        assert p.event.wait(5.0)
        assert p.error is not None and "boom" in str(p.error)
    finally:
        eng.close()


def test_wrong_shape_rejected_and_no_silent_cpu():
    eng = _engine(_toy_fwd, 2)
    try:
        with pytest.raises(ValueError, match="server shape"):
            eng.submit(np.zeros((4, 4, 3), np.float32))
    finally:
        eng.close()
    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchingEngine(_toy_fwd, 2, SHAPE)


def test_http_predict_npy_json_topk_and_health():
    eng = _engine(_toy_fwd, 4)
    httpd, base = _start_http(eng, {"arch": "toy"})
    try:
        imgs = _images(3, seed=1)
        want = imgs.mean(axis=(1, 2))
        code, _, body = _post(base + "/predict", _npy(imgs))
        assert code == 200
        np.testing.assert_allclose(json.loads(body)["predictions"], want,
                                   rtol=1e-5)
        # JSON single instance (3-D -> a batch of one)
        code, _, body = _post(
            base + "/predict",
            json.dumps({"instances": imgs[0].tolist()}).encode(),
            "application/json")
        np.testing.assert_allclose(json.loads(body)["predictions"][0],
                                   want[0], rtol=1e-5)
        code, _, body = _post(base + "/predict?topk=2", _npy(imgs[:1]))
        assert json.loads(body)["topk"][0]["classes"] == \
            np.argsort(-want[0])[:2].tolist()
        for path, data, status in [("/predict", b"not json", 400),
                                   ("/nowhere", b"", 404)]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, data, "application/json")
            assert e.value.code == status
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            assert json.loads(r.read())["requests"] == 5
    finally:
        _stop(httpd, eng)


def test_http_engine_error_and_timeout_codes():
    """500 for an engine error, 504 when the batch outlives the wait."""
    def bad_fwd(x):
        raise RuntimeError("boom")

    for fwd, wait, status in [(bad_fwd, 10.0, 500),
                              (lambda x: (threading.Event().wait(1.0),
                                          _toy_fwd(x))[1], 10.0, 504)]:
        eng = _engine(fwd, 2, max_wait_ms=wait)
        httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), _make_handler(eng, {}, timeout_s=0.3))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"http://127.0.0.1:{httpd.server_address[1]}/predict",
                      _npy(_images(1)))
            assert e.value.code == status
        finally:
            _stop(httpd, eng)


def test_http_detect_export_npz():
    """The pyramid daemon's npz levels are the direct engine forward's."""
    layers = (1, 1, 1, 1)
    sp = prepare_detect_params(MRLABackboneFPN(layers, generator=_gen()),
                               layers=layers, dtype=torch.float32,
                               device="cpu")
    fwd = lambda x: detect_forward(sp, x, layers=layers)
    eng = _engine(fwd, 2, shape=(64, 64, 3))
    httpd, base = _start_http(eng, {"preset": "tiny"})
    try:
        imgs = _images(2, seed=3, shape=(64, 64, 3))
        want = [o.numpy() for o in fwd(torch.from_numpy(imgs))]
        code, ctype, body = _post(base + "/predict", _npy(imgs))
        assert (code, ctype) == (200, "application/x-npz")
        got = np.load(io.BytesIO(body))
        assert set(got.files) == {f"level{i}" for i in range(len(want))}
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"level{i}"], w, atol=1e-5)
    finally:
        _stop(httpd, eng)


def test_build_detect_server_checks_the_presets_levels():
    """build_detect_server passes the preset's start_level / extra convs
    (RetinaNet's P3..P7) and holds the level count to num_outs."""
    layers = (1, 1, 1, 1)
    det = MRLABackboneFPN(layers, start_level=1, add_extra_convs="on_input",
                          generator=_gen())
    httpd, beng = build_detect_server(
        "retinanet_r50mrlal_fpn_1x_coco", det, batch_size=1,
        image_hw=(64, 64), port=0, device="cpu", backbone_layers=layers,
        input_dtype=torch.float32)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        img = _images(1, seed=7, shape=(64, 64, 3))
        _, _, body = _post(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict", _npy(img))
        got = np.load(io.BytesIO(body))
        sp = prepare_detect_params(det, layers=layers, device="cpu")
        want = detect_forward(sp, torch.from_numpy(img).to(torch.bfloat16),
                              layers=layers, start_level=1,
                              add_extra_convs="on_input")
        assert len(got.files) == 5
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"level{i}"],
                                          w.float().numpy())
    finally:
        _stop(httpd, beng)


def test_http_with_real_mrlal_engine():
    """make_engine_forward + the daemon: the rows are the direct
    forward's, whatever the padding rows are."""
    model = ResNetMRLALight(layers=[1, 1], num_classes=7, generator=_gen())
    fwd = make_engine_forward("resnet50_mrlal", model, None, microbatch=0,
                              num_classes=7, device="cpu")
    eng = _engine(fwd, 4, shape=(16, 16, 3))
    httpd, base = _start_http(eng, {"arch": "tiny_mrlal"})
    try:
        imgs = _images(2, seed=2, shape=(16, 16, 3))
        want = fwd(torch.from_numpy(np.concatenate([imgs, imgs]))).numpy()
        code, _, body = _post(base + "/predict", _npy(imgs))
        got = np.asarray(json.loads(body)["predictions"])
        assert code == 200 and got.shape == (2, 7)
        np.testing.assert_allclose(got, want[:2], atol=1e-4)
    finally:
        _stop(httpd, eng)


def test_quant_engine_through_batching_server():
    """--quant int8 through make_engine_forward and the batching engine:
    padding leaves the real rows as the direct forward has them."""
    model = ResNetMRLALight(layers=[1, 1], num_classes=7, generator=_gen())
    calib = _images(2, seed=5, shape=(16, 16, 3))
    fwd = make_engine_forward("resnet50_mrlal", model, None, microbatch=0,
                              num_classes=7, quant="int8", calib_x=calib,
                              device="cpu")
    eng = _engine(fwd, 4, shape=(16, 16, 3))
    try:
        imgs = _images(3, seed=6, shape=(16, 16, 3))
        pend = [eng.submit(im) for im in imgs]
        for p in pend:
            assert p.event.wait(30.0)
            assert p.error is None
        got = np.stack([p.logits for p in pend])
        want = fwd(torch.from_numpy(
            np.concatenate([imgs, imgs[:1]]))).numpy()[:3]
        np.testing.assert_allclose(got, want, atol=1e-4)
    finally:
        eng.close()


def test_http_detections_json():
    """RetinaNet through build_detections_server: JSON boxes / scores /
    labels with the invalid rows dropped, as the direct decode has them."""
    model = RetinaNet(layers=(1, 1, 1, 1), num_classes=3,
                      generator=_gen()).eval()
    httpd, beng = build_detections_server(
        "retinanet_r50mrlal_fpn_1x_coco", model, num_classes=3,
        batch_size=2, image_hw=(128, 128), score_thr=0.005, max_per_img=5,
        port=0, backbone_layers=(1, 1, 1, 1), device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        imgs = _images(2, seed=4, shape=(128, 128, 3))
        with torch.inference_mode(), torch.autocast("cpu", torch.bfloat16):
            wb, ws, wl, wv = [o.float().numpy() for o in get_bboxes(
                model(torch.from_numpy(imgs).to(torch.bfloat16)), (128, 128),
                score_thr=0.005, max_per_img=5)]
        _, _, body = _post(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            _npy(imgs))
        got = json.loads(body)["detections"]
        assert len(got) == 2
        for i, det in enumerate(got):
            m = wv[i].astype(bool)
            assert len(det["boxes"]) == int(m.sum()) > 0
            np.testing.assert_allclose(
                np.asarray(det["boxes"], np.float32).reshape(-1, 4),
                wb[i][m], atol=1e-4)
            np.testing.assert_allclose(det["scores"], ws[i][m], atol=1e-5)
            assert det["labels"] == wl[i][m].astype(int).tolist()
    finally:
        _stop(httpd, beng)


def test_http_detections_with_masks():
    """The mask preset: ?masks=1 returns 28x28 soft masks for each valid
    detection; the plain call leaves them out."""
    model = MaskRCNN(layers=(1, 1, 1, 1), num_classes=3, generator=_gen())
    httpd, beng = build_detections_server(
        "mask_rcnn_r50mrlal_fpn_1x_coco", model, num_classes=3,
        batch_size=1, image_hw=(128, 128), score_thr=0.0, max_per_img=3,
        port=0, num_proposals=10, rpn_nms_pre=50,
        backbone_layers=(1, 1, 1, 1), device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        img = _npy(_images(1, seed=5, shape=(128, 128, 3)))
        for path, want_masks in [("/predict", False),
                                 ("/predict?masks=1", True)]:
            det = json.loads(_post(base + path, img)[2])["detections"][0]
            assert ("masks" in det) == want_masks
            if want_masks:
                marr = np.asarray(det["masks"])
                assert len(det["boxes"]) > 0
                assert marr.shape == (len(det["boxes"]), 28, 28)
                assert ((marr >= 0) & (marr <= 1)).all()
    finally:
        _stop(httpd, beng)


def test_build_detections_server_two_stage():
    """A two-stage preset: the daemon's JSON is two_stage_detections' on
    the same params (its RoIAlign on the presets' exact grid)."""
    layers = (1, 1, 1, 1)
    model = FasterRCNN(layers=layers, num_classes=3, generator=_gen())
    httpd, beng = build_detections_server(
        "faster_rcnn_r50mrlal_fpn_1x_coco", model, num_classes=3,
        batch_size=2, image_hw=(128, 128), port=0, num_proposals=8,
        rpn_nms_pre=32, score_thr=0.0, backbone_layers=layers, device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        imgs = _images(1, seed=4, shape=(128, 128, 3))
        _, _, body = _post(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            _npy(imgs))
        got = json.loads(body)["detections"]
        sp = prepare_detect_params(model, layers=layers, device="cpu")
        x = torch.from_numpy(np.concatenate([imgs, imgs])).to(torch.bfloat16)
        wb, ws, wl, wv = two_stage_detections(
            sp, x, score_thr=0.0, num_proposals=8, rpn_nms_pre=32,
            layers=layers)
        m = wv[0].numpy()
        assert len(got) == 1 and len(got[0]["boxes"]) == int(m.sum()) > 0
        np.testing.assert_allclose(np.asarray(got[0]["boxes"]),
                                   wb[0].numpy()[m], atol=1e-4)
        assert got[0]["labels"] == wl[0].numpy()[m].tolist()
    finally:
        _stop(httpd, beng)


def test_same_request_to_the_jax_and_the_port_daemons():
    """One npy request, the same weights, fp32 engines: the port's daemon
    answers what the JAX package's does."""
    import jax
    import jax.numpy as jnp

    from mrla_tpu.models.resnet_mrla_light import (
        ResNetMRLALight as FlaxResNet,
    )
    from mrla_tpu.serving import (
        prepare_inference_params as j_prepare,
        resnet_mrlal_forward as j_forward,
    )
    from mrla_tpu.serving.server import BatchingEngine as JBatchingEngine
    from mrla_tpu.serving.server import _make_handler as j_make_handler
    from mrla_tpu_torch.ckpt import state_dict_from_jax

    layers = (1, 1)
    flax_model = FlaxResNet(layers=list(layers), num_classes=10)
    variables = jax.device_get(jax.jit(lambda k: flax_model.init(
        k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.key(0)))
    rng = np.random.default_rng(0)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(v.dtype),
        variables["batch_stats"])}
    jsp = j_prepare(variables, layers=layers, dtype=jnp.float32)
    jeng = JBatchingEngine(
        lambda x: j_forward(jsp, jnp.asarray(x), layers=layers,
                            use_pallas=False, microbatch=0),
        batch_size=4, image_shape=(32, 32, 3), max_wait_ms=10.0)
    tsp = prepare_inference_params(state_dict_from_jax(variables),
                                   layers=layers, dtype=torch.float32,
                                   device="cpu")
    teng = _engine(lambda x: resnet_mrlal_forward(tsp, x, layers=layers), 4,
                   shape=(32, 32, 3))
    jhttpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                 j_make_handler(jeng, {"arch": "jax"}))
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    thttpd, tbase = _start_http(teng, {"arch": "port"})
    try:
        body = _npy(rng.standard_normal((3, 32, 32, 3)).astype(np.float32))
        want = json.loads(_post(
            f"http://127.0.0.1:{jhttpd.server_address[1]}/predict", body)[2])
        got = json.loads(_post(tbase + "/predict", body)[2])
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   rtol=RTOL, atol=ATOL)
    finally:
        _stop(jhttpd, jeng)
        _stop(thttpd, teng)
