"""The port's training dataset against the JAX package's, on the CPU.

The same JSON records go through the JAX `SampleDecoder` (PIL for images,
cv2 for contours) and the port's (the native JPEG decoder and border
following, the numpy / native PIL resampler) with the same numpy RNG: every
field must be equal, arrays with `np.array_equal`, strings and lists with
`==`. Records: the JAX tests' PNG records (`tests/test_dataset._fake_record`)
and JPEG records of the committed fixtures (`chip_smoke.training_records`),
with detection captions, BLIP embeddings and per-instance captions added.
"""

import base64
import copy
import io
import json
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import pytest
from PIL import Image

from instancediffusion_tpu.data import jsondataset as jds
from instancediffusion_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
from instancediffusion_tpu_torch.data import jsondataset as pds
from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer

import chip_smoke
from tests.test_dataset import _fake_record


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)):
            assert isinstance(g, (np.ndarray, np.generic)) and g.dtype == w.dtype, k
            assert np.array_equal(g, w), (k, np.abs(np.asarray(g, float) - w).max())
        else:
            assert g == w, (k, g, w)


def _det(rec: dict, seed: int) -> dict:
    """A detection-style copy: is_det, category names, per-instance
    captions on some instances, BLIP embeddings on others."""
    r = np.random.default_rng(seed)
    rec = copy.deepcopy(rec)
    rec["is_det"] = True
    for i, a in enumerate(rec["annos"]):
        a["category_name"] = ["dog", "cat", "person-other", "bench"][i % 4]
        if i % 2:
            a["caption"] = f"a small {a['category_name']} near the door"
        else:
            a.pop("caption", None)
        if i % 3 == 0:
            emb = r.standard_normal(768).astype(np.float32)
            a["blip_clip_embeddings"] = base64.b64encode(emb.tobytes()).decode()
    return rec


@pytest.fixture(scope="module")
def records():
    pngs = [_fake_record(seed=s, n_annos=3 + s) for s in range(3)]
    pngs.append(_fake_record(w=1100, h=1050, n_annos=2, seed=9))  # BOX halving at 512
    jpegs = chip_smoke.training_records(n=9, seed=1)
    for rec in jpegs:  # keep the JAX side's cv2 work small
        rec["annos"] = rec["annos"][:6]
    return {"png": pngs, "jpeg": jpegs}


DECODERS = {
    "center": dict(image_size=128, max_boxes_per_data=8),
    "center_512": dict(image_size=512, max_boxes_per_data=30),
    "random_crop": dict(image_size=128, max_boxes_per_data=8, random_crop=True),
    "drops_both_att": dict(image_size=128, max_boxes_per_data=8,
                           random_drop_embedding="both", return_att_masks=True,
                           prob_use_caption=0.5),
    "drops_image": dict(image_size=96, max_boxes_per_data=4, random_drop_embedding="image"),
}


@pytest.mark.parametrize("kind", ["png", "jpeg"])
@pytest.mark.parametrize("name", sorted(DECODERS))
def test_sample_decoder_matches_jax(records, kind, name):
    """Center and random crops with flips (the RNG flips about half),
    embedding drops, attention-mask rasters, dropped captions: equal to
    JAX's SampleDecoder field for field."""
    recs = records[kind][:4]
    if name == "center_512":  # the real size: the 1100x1050 PNG, every fixture JPEG
        recs = records[kind][-1:] if kind == "png" else records[kind]
    kw = DECODERS[name]
    jdec, pdec = jds.SampleDecoder(**kw), pds.SampleDecoder(**kw)
    for i, rec in enumerate(recs):
        for seed in (0, 1):
            want = jdec(copy.deepcopy(rec), np.random.default_rng((seed, i)))
            got = pdec(copy.deepcopy(rec), np.random.default_rng((seed, i)))
            _assert_same(got, want)


@pytest.mark.parametrize("opts", [dict(), dict(count_dups_make_a_sentence=True),
                                  dict(add_inst_cap_2_global=True, random_blip=0.5)],
                         ids=["det", "det_counts", "det_inst_caps_blip"])
def test_detection_captions_match_jax(records, opts):
    """is_det records: category sentences, counted duplicates, instance
    captions appended with stop words removed, BLIP embedding swaps."""
    kw = dict(image_size=128, max_boxes_per_data=8, **opts)
    jdec, pdec = jds.SampleDecoder(**kw), pds.SampleDecoder(**kw)
    for i, rec in enumerate(records["png"][:2] + records["jpeg"][:2]):
        rec = _det(rec, i)
        for seed in (3, 4):
            want = jdec(copy.deepcopy(rec), np.random.default_rng(seed))
            got = pdec(copy.deepcopy(rec), np.random.default_rng(seed))
            _assert_same(got, want)
            assert want["caption"]


def test_crops_match_jax_on_fixtures():
    """center_crop_image and random_crop_image on every fixture JPEG (with
    masks riding along): equal images, infos and masks."""
    r = np.random.default_rng(0)
    for name in chip_smoke.fixture_jpegs():
        data = open(os.path.join(chip_smoke.FIXTURE_DIR, name), "rb").read()
        pil = Image.open(io.BytesIO(data)).convert("RGB")
        arr = pds.decode_image(data)
        segs = (r.random((2, arr.shape[0], arr.shape[1])) < 0.3).astype(np.uint8)
        for size in (128, 512):
            want = jds.center_crop_image(pil, size, segs)
            got = pds.center_crop_image(arr, size, segs)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[2], want[2])
        want = jds.random_crop_image(pil, 256, segs, np.random.default_rng(7))
        got = pds.random_crop_image(arr, 256, segs, np.random.default_rng(7))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])


def _write(records, path):
    path.mkdir()
    files = []
    for i, rec in enumerate(records):
        files.append(path / f"{i}.json")
        files[-1].write_text(json.dumps(rec))
    listing = path / "train.txt"
    listing.write_text("\n".join(f.name for f in files) + "\n")  # relative to the list
    return str(listing)


def test_prefetcher_matches_jax_over_two_epochs(records, tmp_path):
    """The port's Prefetcher (3 decode processes) gives JAX's batches in JAX's
    order over 2 epochs: the shuffle default_rng((seed, epoch)), each
    sample's default_rng((seed, epoch, idx)), collate and caption ids."""
    listing = _write(records["png"][:3] + records["jpeg"][:3], tmp_path / "recs")
    kw = dict(image_size=64, max_boxes_per_data=6)
    jloader = jds.Prefetcher(jds.JsonDataset(listing, jds.SampleDecoder(**kw), seed=5), 2,
                             tokenizer=JaxTokenizer.load_default(), seed=5)
    ploader = pds.Prefetcher(pds.JsonDataset(listing, pds.SampleDecoder(**kw), seed=5), 2,
                             tokenizer=CLIPTokenizer.load_default(), seed=5, workers=3)
    try:
        for epoch in (0, 1):
            want = list(jloader.epoch(epoch))
            got = list(ploader.epoch(epoch))
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                _assert_same(g, w)
    finally:
        ploader.close()
    sample = ploader.ds.__getitem__(2, epoch=1)
    _assert_same(sample, jloader.ds.__getitem__(2, epoch=1))
    batch = pds.collate([sample, sample], CLIPTokenizer.load_default(), keep_caption=True)
    _assert_same(batch, jds.collate([sample, sample], JaxTokenizer.load_default(),
                                    keep_caption=True))


def test_prefetcher_raises_producer_failures_and_stops_early(records, tmp_path):
    """A record that fails to decode (in a decode process) raises in the
    consumer, not hanging it; leaving an epoch early stops its producer
    thread, and close() ends the decode processes."""
    bad = copy.deepcopy(records["png"][0])
    bad["image"] = "R0lGODlh"  # base64 of a GIF header
    listing = _write([bad] + records["png"][:3], tmp_path / "bad")
    kw = dict(image_size=64, max_boxes_per_data=4)
    loader = pds.Prefetcher(pds.JsonDataset(listing, pds.SampleDecoder(**kw)), 1,
                            shuffle=False, workers=2)
    with pytest.raises(ValueError, match="GIF"):
        list(loader.epoch(0))
    loader.close()
    listing = _write(records["png"][:3], tmp_path / "good")
    loader = pds.Prefetcher(pds.JsonDataset(listing, pds.SampleDecoder(**kw)), 1, depth=1,
                            workers=2)
    it = loader.epoch(0)
    next(it)
    producers = lambda: [t for t in threading.enumerate() if t.name.startswith("prefetcher")]
    assert producers()
    it.close()
    for _ in range(100):
        if not producers():
            break
        threading.Event().wait(0.05)
    assert not producers()
    assert len(multiprocessing.active_children()) == 2
    loader.close()
    assert not multiprocessing.active_children()


def test_decode_processes_leave_preemption_signals_to_the_parent(records, tmp_path):
    """SIGINT, SIGUSR1 and SIGTERM sent to the decode processes mid-epoch
    (a scheduler signals every process of a job) end none of them and lose
    no sample; close() still ends them."""
    listing = _write(records["png"][:4], tmp_path / "recs")
    kw = dict(image_size=64, max_boxes_per_data=4)
    loader = pds.Prefetcher(pds.JsonDataset(listing, pds.SampleDecoder(**kw)), 1,
                            shuffle=False, workers=2)
    try:
        it = loader.epoch(0)
        batches = [next(it)]
        procs = multiprocessing.active_children()
        assert len(procs) == 2
        for sig in (signal.SIGINT, signal.SIGUSR1, signal.SIGTERM):
            for p in procs:
                os.kill(p.pid, sig)
        time.sleep(0.5)
        assert all(p.is_alive() for p in procs)
        rest = threading.Thread(target=lambda: batches.extend(it), daemon=True)
        rest.start()
        rest.join(60)
        assert not rest.is_alive(), "a sample was lost"
        assert [b["image"].shape[0] for b in batches] == [1, 1, 1, 1]
        assert sorted(multiprocessing.active_children(), key=id) == sorted(procs, key=id)
    finally:
        loader.close()
    assert not multiprocessing.active_children()
