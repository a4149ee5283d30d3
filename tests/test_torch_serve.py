"""The port's micro-batching server (`instancediffusion_tpu_torch/serve.py`):
BatchingQueue with a fake backend (padding, exceptions, concurrency), the
stdlib PNG encoder, and a tiny HTTP round trip on the CPU whose decoded PNG
is the image `generate_batch` makes for the same meta and seed."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from instancediffusion_tpu_torch import serve
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests.test_pipeline import tiny_config
from tests.test_torch_bridge import dense_params, port_config


class FakeBackend:
    """Records calls; returns per-request images watermarked with the seed."""

    def __init__(self, delay_s=0.0):
        self.calls = []
        self.delay_s = delay_s

    def __call__(self, metas, seeds=None, **kw):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.calls.append((list(metas), list(seeds), kw))
        out = np.zeros((len(metas), 2, 2, 3), np.uint8)
        for i, s in enumerate(seeds):
            out[i, 0, 0, 0] = s
        return out


def test_batching_pads_to_fixed_size_and_trims():
    fake = FakeBackend()
    bq = serve.BatchingQueue(fake, batch_size=4, max_wait_ms=30.0, steps=7)
    futs = [bq.submit({"prompt": f"p{i}"}, seed=10 + i) for i in range(5)]
    imgs = [f.result(timeout=10) for f in futs]
    bq.close()
    # 5 requests: one full batch of 4, one batch of 1 padded to 4
    assert len(fake.calls) == 2
    (m0, s0, kw0), (m1, s1, _) = fake.calls
    assert len(m0) == 4 and s0 == [10, 11, 12, 13]
    assert len(m1) == 4 and s1 == [14, 14, 14, 14]
    assert m1[0]["prompt"] == "p4" and m1[-1]["prompt"] == "p4"
    assert kw0 == {"steps": 7}
    for i, img in enumerate(imgs):  # each request its own image, padding dropped
        assert img.shape == (2, 2, 3) and img[0, 0, 0] == 10 + i
    assert bq.requests == 5 and bq.batches == 2 and len(bq.batch_seconds) == 2


def test_batching_exception_resolves_all_futures():
    def boom(metas, seeds=None, **kw):
        raise RuntimeError("backend down")

    bq = serve.BatchingQueue(boom, batch_size=2, max_wait_ms=10.0)
    futs = [bq.submit({"prompt": "x"}) for _ in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="backend down"):
            f.result(timeout=10)
    bq.close()
    assert bq.batches == 0


def test_concurrent_submissions_share_one_batch():
    fake = FakeBackend(delay_s=0.05)
    bq = serve.BatchingQueue(fake, batch_size=8, max_wait_ms=200.0)
    futs = []
    threads = [threading.Thread(target=lambda i=i: futs.append((i, bq.submit(
        {"prompt": str(i)}, seed=i)))) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, f in futs:
        assert f.result(timeout=10)[0, 0, 0] == i
    bq.close()
    assert bq.batches == 1, fake.calls


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG with filter 0 rows (what png_bytes writes) -> array;
    checks each chunk's CRC."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert crc == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    assert chunks[b"IHDR"][8:] == bytes([8, 2, 0, 0, 0]) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1, 3), (16, 24, 3), (64, 64, 3)])
def test_png_bytes_round_trip(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(serve.png_bytes(img)), img)
    with pytest.raises(ValueError, match="H, W, 3"):
        serve.png_bytes(img[..., 0])


def test_main_refuses_a_checkpoint():
    with pytest.raises(NotImplementedError, match="checkpoint loader"):
        serve.main(["--ckpt", "weights.pth"])


@pytest.fixture(scope="module")
def tiny_pipe_port():
    cfg = tiny_config()
    pipe = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                 dtype=torch.float32)
    load_jax_params(pipe, **dense_params(cfg, seed=5))
    return pipe


def _post(port, body: dict, query=""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate{query}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def test_http_end_to_end(tiny_pipe_port):
    """serve(port=0) on the tiny pipeline (DPM, 4 steps, batch 2): health,
    a PNG reply equal to generate_batch's image for the same meta and seed,
    the JSON variant, and a 400 on a malformed request."""
    pipe = tiny_pipe_port
    g = pipe.cfg.model.grounding_tokenizer
    meta = {"prompt": "a thing", "phrases": ["a thing"], "locations": [[0.2, 0.2, 0.8, 0.8]],
            "points": [[0.5, 0.5]], "scribbles": [[0.3] * (g.n_scribble_points * 2)]}
    kw = dict(steps=4, mis=0.0, sampler="dpm")
    server = serve.serve(pipe, port=0, batch_size=2, max_wait_ms=20.0, **kw)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["device"] == "cpu" and health["requests"] >= 2
        with _post(port, dict(meta, seed=7)) as r:
            assert r.headers["Content-Type"] == "image/png"
            img = decode_png(r.read())
        want = pipe.generate_batch([meta, meta], seeds=[7, 7], **kw)[0]
        assert img.shape == (pipe.image_size, pipe.image_size, 3)
        np.testing.assert_array_equal(img, want)
        assert int(img.max()) > int(img.min())
        with _post(port, dict(meta, seed=7), "?format=json") as r:
            payload = json.loads(r.read())
        np.testing.assert_array_equal(decode_png(base64.b64decode(payload["png_base64"])), want)
        assert payload["shape"] == [pipe.image_size, pipe.image_size, 3]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, {})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
