"""The port's image decoding, encoding and resampling against PIL, bit for
bit, its polygon fill and cubic resize against cv2, and its native data
library against its numpy versions (CPU).

PIL (Pillow with libjpeg-turbo) is the oracle: `data/jpeg.decode_image`
must return exactly `Image.open(BytesIO(b)).convert("RGB")`,
`data/jpeg.encode_jpeg` the bytes of Pillow's default JPEG save, and
`data/resample.resize` exactly `Image.resize` with BOX, BICUBIC, LANCZOS
and NEAREST. The committed fixtures (tools/make_torch_jpeg_fixtures.py) carry
PIL's hashes for the card host, which has no PIL.
"""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from instancediffusion_tpu_torch.data import _native
from instancediffusion_tpu_torch.data import geometry as pgeo
from instancediffusion_tpu_torch.data import resample
from instancediffusion_tpu_torch.data.jpeg import decode_image, encode_jpeg, encode_jpeg_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "jpeg")
EXPECTED = json.load(open(os.path.join(FIXTURES, "expected.json")))
PIL_METHODS = {resample.BOX: Image.Resampling.BOX, resample.BICUBIC: Image.Resampling.BICUBIC,
               resample.NEAREST: Image.Resampling.NEAREST}


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _scene(w: int, h: int, seed: int, gray: bool = False) -> Image.Image:
    """Smooth colour waves plus noise: real AC coefficients at every
    quality."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 90 * np.sin(x / r.uniform(3, 30) + c) * np.cos(y / r.uniform(3, 30) - c)
                  for c in range(3)], -1) + r.normal(0, r.uniform(0, 40), (h, w, 3))
    im = Image.fromarray(np.clip(a, 0, 255).astype(np.uint8))
    return im.convert("L") if gray else im


def _jpeg(im: Image.Image, **opts) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="JPEG", **opts)
    return buf.getvalue()


# -- the decoder --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_decodes_as_pil(name):
    """Each fixture (4:2:0, 4:4:4, 4:2:2, gray, restarts, optimised tables,
    progressive, odd size, 1280x1024) decodes to PIL's RGB bytes, and
    expected.json holds PIL's hash and mode."""
    data = open(os.path.join(FIXTURES, name), "rb").read()
    want = _pil_rgb(data)
    got = decode_image(data)
    np.testing.assert_array_equal(got, want)
    e = EXPECTED[name]
    assert hashlib.sha256(got.tobytes()).hexdigest() == e["rgb_sha256"]
    assert list(got.shape[1::-1]) == e["size"]
    assert Image.open(io.BytesIO(data)).mode == e["mode"]
    assert _native.jpeg_info(data)[2] == (1 if e["mode"] == "L" else 3)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(w=st.integers(1, 300), h=st.integers(1, 300), quality=st.integers(1, 100),
       subsampling=st.sampled_from([0, 1, 2]), gray=st.booleans(), optimize=st.booleans(),
       restart=st.sampled_from([0, 0, 1, 3, 7]), progressive=st.booleans(),
       seed=st.integers(0, 2**16))
def test_decoder_equals_pil(w, h, quality, subsampling, gray, optimize, restart, progressive,
                            seed):
    """Random sizes, qualities, subsamplings, gray, optimised Huffman
    tables, restart intervals and progressive coding: PIL's bytes exactly."""
    opts = dict(quality=quality, optimize=optimize, progressive=progressive)
    if not gray:
        opts["subsampling"] = subsampling
    if restart:
        opts["restart_marker_blocks"] = restart
    data = _jpeg(_scene(w, h, seed, gray), **opts)
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))


def _with_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


@pytest.mark.parametrize("marker, words", [(0xC3, "SOF3"), (0xC5, "SOF5"), (0xC9, "SOF9"),
                                           (0xCA, "SOF10"), (0xCB, "SOF11"), (0xCF, "SOF15")])
def test_unsupported_sof_raises_naming_it(marker, words):
    """Lossless, hierarchical and arithmetic-coded frames raise ValueError
    naming the SOF marker."""
    data = _with_sof(_jpeg(_scene(32, 24, 0)), marker)
    with pytest.raises(ValueError, match=words):
        decode_image(data)


def test_twelve_bit_cmyk_and_other_formats_raise():
    """12-bit samples, 4-component (CMYK / YCCK) JPEGs and formats other
    than JPEG and PNG raise ValueError naming them."""
    data = bytearray(_jpeg(_scene(16, 16, 1)))
    i = data.index(b"\xff\xc0")
    data[i + 4] = 12  # the frame's sample precision
    with pytest.raises(ValueError, match="12-bit"):
        decode_image(bytes(data))
    cmyk = _jpeg(_scene(16, 16, 2).convert("CMYK"))
    with pytest.raises(ValueError, match="4 components"):
        decode_image(cmyk)
    for fmt in ("GIF", "BMP", "TIFF", "WEBP"):
        buf = io.BytesIO()
        _scene(8, 8, 3).save(buf, format=fmt)
        with pytest.raises(ValueError, match=fmt):
            decode_image(buf.getvalue())


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_records_decode_as_pil(mode):
    """PNG images (as the JAX package's tests write them) decode to PIL's
    convert("RGB"): gray replicated, alpha dropped."""
    im = _scene(37, 23, 4)
    im = im.convert(mode) if mode != "LA" else im.convert("L").convert("LA")
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    np.testing.assert_array_equal(decode_image(buf.getvalue()), _pil_rgb(buf.getvalue()))


# -- the resampler -------------------------------------------------------------


@settings(max_examples=150, deadline=None, derandomize=True)
@given(w=st.integers(1, 160), h=st.integers(1, 160), ow=st.integers(1, 240),
       oh=st.integers(1, 240), method=st.sampled_from(sorted(PIL_METHODS)),
       gray=st.booleans(), binary=st.booleans(), seed=st.integers(0, 2**16))
def test_resize_equals_pil(w, h, ow, oh, method, gray, binary, seed):
    """BOX, BICUBIC and NEAREST on RGB and L, up and down, at random sizes
    (binary masks too, as the loader resizes instance masks): PIL's bytes
    exactly, native passes and numpy passes alike."""
    r = np.random.default_rng(seed)
    shape = (h, w) if gray else (h, w, 3)
    img = (r.random(shape) < 0.5).astype(np.uint8) if binary else \
        r.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), PIL_METHODS[method]))
    np.testing.assert_array_equal(resample.resize(img, (ow, oh), method), want)
    np.testing.assert_array_equal(resample.resize_numpy(img, (ow, oh), method), want)


@pytest.mark.parametrize("src, dst", [((640, 480), (683, 512)), ((480, 640), (512, 683)),
                                      ((1280, 1024), (640, 512)), ((641, 427), (320, 213)),
                                      ((500, 375), (683, 512))])
def test_resize_at_loader_sizes_equals_pil(src, dst):
    """The loader's own resizes (COCO sizes to a 512 short side, BOX halving
    of odd sizes), each method, on a smooth image."""
    img = np.asarray(_scene(*src, seed=5))
    for method, pil in PIL_METHODS.items():
        np.testing.assert_array_equal(resample.resize(img, dst, method),
                                      np.asarray(Image.fromarray(img).resize(dst, pil)))


def test_nearest_is_pils_accumulated_position():
    """PIL's NEAREST adds in / out once per pixel in float64; where
    (i + 0.5) * in / out is a whole number the sum can fall short of it, so
    the index is not always floor((i + 0.5) * in / out)."""
    differs = 0
    for n_in in range(1, 200):
        for n_out in range(1, 200, 7):
            img = np.arange(n_in, dtype=np.uint8)[:, None].repeat(2, 1)
            want = np.asarray(Image.fromarray(img).resize((2, n_out), Image.Resampling.NEAREST))
            got = resample.resize(img, (2, n_out), resample.NEAREST)
            np.testing.assert_array_equal(got, want)
            exact = np.floor((np.arange(n_out) + 0.5) * n_in / n_out).astype(np.uint8)
            differs += int((got[:, 0] != exact).sum())
    assert differs > 0


# -- the native library ----------------------------------------------------------


def test_native_rle_matches_numpy():
    """rle_decode's native path equals the numpy path; the native encode
    equals geometry.rle_encode; the native normalise equals x / 127.5 - 1."""
    r = np.random.default_rng(0)
    for _ in range(30):
        h, w = (int(v) for v in r.integers(1, 90, 2))
        m = (r.random((h, w)) < r.uniform(0.05, 0.95)).astype(np.uint8)
        rle = pgeo.rle_encode(m)
        np.testing.assert_array_equal(pgeo.rle_decode(rle), pgeo.rle_decode_numpy(rle))
        np.testing.assert_array_equal(pgeo.rle_decode(rle)[:, :, 0], m)
        assert _native.rle_encode_native(m).decode() == rle["counts"]
    img = r.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_native.normalize_image_native(img),
                                  img.astype(np.float32) / np.float32(127.5) - np.float32(1.0))


def test_native_contours_match_numpy():
    """The native border following gives find_contours_numpy's contours,
    points and order, on speckle, rings, lines and edge-touching blobs."""
    r = np.random.default_rng(1)
    masks = [(r.random((int(h), int(w))) < p).astype(np.uint8)
             for h, w, p in zip(r.integers(1, 70, 40), r.integers(1, 70, 40), r.uniform(.1, .9, 40))]
    ring = np.zeros((40, 40), np.uint8)
    ring[5:35, 5:35] = 1
    ring[12:28, 12:28] = 0
    line = np.zeros((20, 30), np.uint8)
    line[7, :] = 1
    edge = np.ones((15, 15), np.uint8)
    for m in masks + [ring, line, edge, np.zeros((9, 9), np.uint8)]:
        got, want = pgeo.find_contours(m), pgeo.find_contours_numpy(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_native_interior_points_match_numpy():
    """The native ranking of interior polygon points equals
    sample_uniform_sparse_points_numpy (numpy's stable argsort of float64
    distances to the centroid), ties included; masks with fewer than k
    pixels take the numpy path and its RNG."""
    r = np.random.default_rng(2)
    yy, xx = np.mgrid[0:120, 0:160]
    shapes = [np.ones((31, 47), np.uint8), (((yy - 60) / 40) ** 2 + ((xx - 80) / 55) ** 2 < 1)
              .astype(np.uint8), np.zeros((5, 5), np.uint8)]
    shapes += [(r.random((int(h), int(w))) < p).astype(np.uint8)
               for h, w, p in zip(r.integers(1, 90, 30), r.integers(1, 90, 30),
                                  r.uniform(0, 0.9, 30))]
    for m in shapes:
        for k in (1, 7, 128, 300):
            got = pgeo.sample_uniform_sparse_points(m, k, np.random.default_rng(3))
            want = pgeo.sample_uniform_sparse_points_numpy(m, k, np.random.default_rng(3))
            assert got == want, (m.shape, k)


def test_native_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """A library that does not build raises (no numpy fallback)."""
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _native.get_lib()
    assert not list((tmp_path / "native").rglob("*.so"))


def test_native_builds_concurrently(tmp_path):
    """Six processes building the library into one empty directory at once
    (as pytest-xdist's workers do) all load it, and one library is left."""
    code = ("import sys, pathlib\n"
            "from instancediffusion_tpu_torch.data import _native\n"
            "_native.BUILD_ROOT = pathlib.Path(sys.argv[1])\n"
            "print(_native.jpeg_info(open(sys.argv[2], 'rb').read()))\n")
    fixture = os.path.join(FIXTURES, sorted(EXPECTED)[0])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), fixture], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
    assert len({o[0] for o in outs}) == 1
    built = list(tmp_path.rglob("*.so"))
    assert len(built) == 1 and built[0].name == _native.LIB_NAME


# -- sampling layouts PIL's encoder does not write -------------------------------


def _bits(codes):
    """Bytes of (value, length) pairs, 0xFF stuffed, padded with ones."""
    out, acc, n = bytearray(), 0, 0
    for v, length in codes:
        acc = (acc << length) | (v & ((1 << length) - 1))
        n += length
        while n >= 8:
            byte = (acc >> (n - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            n -= 8
    if n:
        byte = ((acc << (8 - n)) | ((1 << (8 - n)) - 1)) & 0xFF
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    return bytes(out)


def _category(v):
    return int(abs(v)).bit_length()


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _baseline_jpeg(rgb, factors, ids=(1, 2, 3), header="jfif", interleaved=True, q=6):
    """A baseline JPEG of an (H, W, 3) uint8 image with the given (h, v)
    sampling factors per component, written here because PIL's encoder
    writes only 4:4:4, 4:2:2 and 4:2:0 in one interleaved scan. Canonical
    Huffman codes of fixed length (DC 4 bits, AC 8 bits) and a flat
    quantisation table keep it short; PIL decodes the result as the
    oracle. header: "jfif" (YCbCr), "adobe_rgb" (APP14 transform 0: the
    components are R, G, B) or None."""
    h_img, w_img = rgb.shape[:2]
    x = rgb.astype(np.float64)
    if header == "adobe_rgb" or ids == (82, 71, 66):
        planes = [x[..., 0], x[..., 1], x[..., 2]]
    else:
        y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        planes = [y, (x[..., 2] - y) * 0.564 + 128, (x[..., 0] - y) * 0.713 + 128]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    comps = []
    for plane, (fh, fv) in zip(planes, factors):
        cw, ch = -(-w_img * fh // hmax), -(-h_img * fv // vmax)
        sy, sx = vmax // fv, hmax // fh
        pad = np.pad(plane, ((0, ch * sy - h_img), (0, cw * sx - w_img)), mode="edge")
        small = pad.reshape(ch, sy, cw, sx).mean((1, 3))
        bw, bh = mcux * fh, mcuy * fv
        full = np.pad(small, ((0, bh * 8 - ch), (0, bw * 8 - cw)), mode="edge") - 128
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.rint(dct @ blocks @ dct.T / q).astype(int)  # (bh, bw, 8, 8)
        comps.append(dict(h=fh, v=fv, coef=coef, cw=cw, ch=ch))
    zz = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
          34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    ac_code = {sym: i for i, sym in enumerate(ac_syms)}

    def block_codes(blk, pred):
        flat = blk.reshape(64)[zz]
        codes, diff = [], int(flat[0]) - pred
        c = _category(diff)
        codes += [(c, 4)] + ([(diff if diff > 0 else diff - 1, c)] if c else [])
        run = 0
        last = max([i for i in range(1, 64) if flat[i]] or [0])
        for i in range(1, last + 1):
            v = int(flat[i])
            if not v:
                run += 1
                continue
            while run > 15:
                codes.append((ac_code[0xF0], 8))
                run -= 16
            c = _category(v)
            codes += [(ac_code[(run << 4) | c], 8), (v if v > 0 else v - 1, c)]
            run = 0
        if last < 63:
            codes.append((ac_code[0x00], 8))
        return codes, int(flat[0])

    def scan(members):
        codes, preds = [], [0] * len(comps)
        if len(members) == 1:
            c = comps[members[0]]
            order = [(members[0], by, bx) for by in range(-(-c["ch"] // 8))
                     for bx in range(-(-c["cw"] // 8))]
        else:
            order = [(ci, my * comps[ci]["v"] + by, mx * comps[ci]["h"] + bx)
                     for my in range(mcuy) for mx in range(mcux) for ci in members
                     for by in range(comps[ci]["v"]) for bx in range(comps[ci]["h"])]
        for ci, by, bx in order:
            cc, preds[ci] = block_codes(comps[ci]["coef"][by, bx], preds[ci])
            codes += cc
        body = bytes([len(members)]) + b"".join(bytes([ids[ci], 0x00]) for ci in members)
        return _segment(0xDA, body + bytes([0, 63, 0])) + _bits(codes)

    out = b"\xff\xd8"
    if header == "jfif":
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif header == "adobe_rgb":
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    out += _segment(0xDB, bytes([0]) + bytes([q] * 64))
    sof = bytes([8]) + h_img.to_bytes(2, "big") + w_img.to_bytes(2, "big") + bytes([len(comps)])
    sof += b"".join(bytes([ids[i], (c["h"] << 4) | c["v"], 0]) for i, c in enumerate(comps))
    out += _segment(0xC0, sof)
    dc_bits = bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
    ac_bits = bytes([0] * 7 + [len(ac_syms)] + [0] * 8) + bytes(ac_syms)
    out += _segment(0xC4, bytes([0x00]) + dc_bits + bytes([0x10]) + ac_bits)
    if interleaved:
        out += scan(list(range(len(comps))))
    else:
        out += b"".join(scan([ci]) for ci in range(len(comps)))
    return out + b"\xff\xd9"


LAYOUTS = {
    "440_h1v2": dict(factors=[(1, 2), (1, 1), (1, 1)]),
    "420": dict(factors=[(2, 2), (1, 1), (1, 1)]),
    "422_separate_scans": dict(factors=[(2, 1), (1, 1), (1, 1)], interleaved=False),
    "411_h4v1": dict(factors=[(4, 1), (1, 1), (1, 1)]),
    "420_chroma_1x2_2x1": dict(factors=[(2, 2), (1, 2), (2, 1)]),
    "adobe_rgb": dict(factors=[(1, 1), (1, 1), (1, 1)], header="adobe_rgb"),
    "rgb_ids_420": dict(factors=[(2, 2), (1, 1), (1, 1)], ids=(82, 71, 66), header=None),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("size", [(61, 45), (3, 17), (2, 2), (16, 1)])
def test_sampling_layouts_decode_as_pil(layout, size):
    """h1v2 (4:4:0) fancy upsampling, 4:2:0, 4:2:2 in one scan per
    component, 4:1:1 (replication), mixed chroma factors, Adobe RGB and 'R',
    'G', 'B' component ids, at sizes where the chroma is 2 samples wide or
    less (replication instead of the triangle filter) and not a multiple
    of the MCU: PIL's bytes exactly."""
    w, h = size
    data = _baseline_jpeg(np.asarray(_scene(w, h, 8)), **LAYOUTS[layout])
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data))


# -- the JPEG encoder ----------------------------------------------------------


def _pil_jpeg(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert("RGB").save(buf, format="JPEG")
    return buf.getvalue()


def _content(r, h: int, w: int, kind: str) -> np.ndarray:
    if kind == "noise":
        return r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(r.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    y, x = np.mgrid[0:h, 0:w]  # a gradient with a few saturated blocks
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) % 256], -1)
    img[r.random((h, w)) < 0.05] = 255
    return img.astype(np.uint8)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(w=st.integers(1, 70), h=st.integers(1, 70),
       kind=st.sampled_from(["noise", "flat", "gradient"]), seed=st.integers(0, 2**16))
def test_encode_jpeg_equals_pil(w, h, kind, seed):
    """encode_jpeg writes Pillow's default JPEG (quality 75, 4:2:0) byte for
    byte: odd sizes (partial MCUs, dummy blocks), flat and noisy content;
    the numpy encoder writes the same bytes."""
    img = _content(np.random.default_rng(seed), h, w, kind)
    want = _pil_jpeg(img)
    assert encode_jpeg(img) == want
    assert encode_jpeg_numpy(img) == want


def test_encode_jpeg_of_generated_images_equals_pil():
    """The 512x512 images of a tiny pipeline (32x32 latents, a VAE of five
    levels of 32 channels, 2 PLMS steps, float32 on the CPU), as the COCO
    eval and the labeler write them."""
    import dataclasses

    import torch

    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    from tests.test_pipeline import META, tiny_config
    from tests.test_torch_bridge import port_config

    cfg = port_config(tiny_config())
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=32),
        autoencoder=dataclasses.replace(cfg.autoencoder, ch_mult=(1,) * 5, resolution=512))
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=0, device="cpu", dtype=torch.float32)
    imgs = pipe.generate(dict(META, segs=None), num_images=2, steps=2, mis=0.0)
    assert imgs.shape == (2, 512, 512, 3) and int(imgs.max()) - int(imgs.min()) > 10
    for img in imgs:
        assert encode_jpeg(img) == _pil_jpeg(img)


def test_encode_jpeg_refuses_other_layouts(tmp_path, monkeypatch):
    """Only (H, W, 3) uint8; a library that does not build raises."""
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 3), np.float32),
                np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            encode_jpeg(bad)
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        encode_jpeg(np.zeros((8, 8, 3), np.uint8))


# -- LANCZOS, fillPoly and INTER_CUBIC -------------------------------------------


@settings(max_examples=60, deadline=None, derandomize=True)
@given(w=st.integers(1, 120), h=st.integers(1, 120), ow=st.integers(1, 200),
       oh=st.integers(1, 200), gray=st.booleans(), seed=st.integers(0, 2**16))
def test_lanczos_resize_equals_pil(w, h, ow, oh, gray, seed):
    """LANCZOS (Resample.c's lanczos_filter, support 3) up and down on RGB
    and L: PIL's bytes exactly, native and numpy passes alike."""
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (h, w) if gray else (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.LANCZOS))
    np.testing.assert_array_equal(resample.resize(img, (ow, oh), resample.LANCZOS), want)
    np.testing.assert_array_equal(resample.resize_numpy(img, (ow, oh), resample.LANCZOS), want)


@st.composite
def _polygons(draw):
    """1-3 polygons of 1-12 integer vertices, up to 40 px off a (1-60)^2
    image on every side (self-intersecting as they come)."""
    h, w = draw(st.integers(1, 60)), draw(st.integers(1, 60))
    polys = []
    for _ in range(draw(st.integers(1, 3))):
        n = draw(st.integers(1, 12))
        xs = draw(st.lists(st.integers(-40, w + 40), min_size=n, max_size=n))
        ys = draw(st.lists(st.integers(-40, h + 40), min_size=n, max_size=n))
        polys.append(np.stack([xs, ys], 1).astype(np.int32))
    return h, w, polys


@settings(max_examples=300, deadline=None, derandomize=True)
@given(case=_polygons())
def test_fill_poly_equals_cv2(case):
    """fill_poly is cv2.fillPoly(mask, polygons, 1) bit for bit: several
    parts in one call, crossing edges, vertices off the image."""
    import cv2

    h, w, polys = case
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, polys, 1)
    np.testing.assert_array_equal(pgeo.fill_poly(np.zeros((h, w), np.uint8), polys), want)


def test_fill_poly_of_coco_polygons_equals_cv2():
    """COCO-like polygons (float vertices rounded, some on the far border,
    hundreds of vertices) on COCO-sized masks, one cv2 call each."""
    import cv2

    r = np.random.default_rng(6)
    for w, h in ((640, 480), (480, 640), (500, 375), (333, 251)):
        for _ in range(20):
            pts = np.round(np.reshape(chip_smoke._coco_polygon(r, w, h), (-1, 2))).astype(np.int32)
            want = np.zeros((h, w), np.uint8)
            cv2.fillPoly(want, [pts], 1)
            np.testing.assert_array_equal(pgeo.fill_poly(np.zeros((h, w), np.uint8), [pts]),
                                          want)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(w=st.integers(1, 90), h=st.integers(1, 90), ow=st.integers(1, 260),
       oh=st.integers(1, 260), gray=st.booleans(), seed=st.integers(0, 2**16))
def test_resize_cubic_equals_cv2(w, h, ow, oh, gray, seed):
    """resize_cubic is OpenCV's own cv2.resize(..., INTER_CUBIC) on uint8 bit
    for bit (cv2's Intel IPP route, which
    rounds some near-half values the other way, off for the comparison)."""
    import cv2

    img = np.random.default_rng(seed).integers(0, 256, (h, w) if gray else (h, w, 3),
                                               dtype=np.uint8)
    old = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(old)
    np.testing.assert_array_equal(pgeo.resize_cubic(img, ow, oh), want)
