"""The port's labeling pipeline and COCO converter (`datagen/`) against the
JAX package's (`datagen/label.py`, `datagen/backends.py`) and
`tools/coco_to_training_jsons.py`, on the COCO oracle backend over the
fixture JPEGs; the port's loader reads what they write."""

import base64
import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from instancediffusion_tpu.datagen import backends as jb
from instancediffusion_tpu.datagen import label as jl
from instancediffusion_tpu.pipeline import InstanceDiffusionPipeline as JaxPipeline
from instancediffusion_tpu.pipeline import PipelineParams
from instancediffusion_tpu_torch.data import _native
from instancediffusion_tpu_torch.data.jsondataset import JsonDataset, SampleDecoder
from instancediffusion_tpu_torch.datagen import backends as pb
from instancediffusion_tpu_torch.datagen import coco_to_training_jsons as pc2t
from instancediffusion_tpu_torch.datagen import label as pl
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests.test_pipeline import tiny_config
from tests.test_torch_bridge import dense_params, port_config, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# embeddings of the tiny CLIP tower: float32 in another summation order
EMB_TOL = 1e-5


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """An instances JSON over the fixture JPEGs (every image annotated) and
    the labeler's entries list."""
    out = tmp_path_factory.mktemp("oracle")
    images = []
    for name in chip_smoke.fixture_jpegs():
        with open(os.path.join(chip_smoke.FIXTURE_DIR, name), "rb") as f:
            w, h, _, _ = _native.jpeg_info(f.read())
        images.append((name, w, h))
    inst, _ = chip_smoke.write_synthetic_coco(str(out), images, seed=9, empty_last=False)
    entries = [{"image": os.path.join(chip_smoke.FIXTURE_DIR, n), "caption": f"scene {i}"}
               for i, (n, _, _) in enumerate(images)]
    path = out / "entries.json"
    path.write_text(json.dumps(entries))
    return inst, str(path), entries


@pytest.fixture(scope="module")
def embedders():
    """ClipPhraseEmbedders of both packages on one tiny bridged pipeline
    (the memo and encode_phrases; the checkpoint path is the constructor's
    only other work)."""
    cfg = tiny_config()
    trees = dense_params(cfg, seed=41)
    jpipe = JaxPipeline(cfg, PipelineParams(**{k: to_jax(v) for k, v in trees.items()}))
    ppipe = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                  dtype=torch.float32)
    load_jax_params(ppipe, **trees)
    je, pe = jb.ClipPhraseEmbedder.__new__(jb.ClipPhraseEmbedder), \
        pb.ClipPhraseEmbedder.__new__(pb.ClipPhraseEmbedder)
    je._pipe, je._cache, pe._pipe, pe._cache = jpipe, {}, ppipe, {}
    return je, pe


def _pipelines(inst, jemb, pemb, iou_threshold=0.5):
    args = type("A", (), {"box_threshold": 0.25, "iou_threshold": iou_threshold})()
    return jl._oracle_pipeline(inst, jemb, args), pl._oracle_pipeline(inst, pemb, args)


def _same_record(ref: dict, out: dict, emb_tol: float = 0.0):
    assert list(ref) == list(out)
    for key in ref:
        if key != "annos":
            assert ref[key] == out[key], key
    assert len(ref["annos"]) == len(out["annos"])
    for ra, oa in zip(ref["annos"], out["annos"]):
        assert list(ra) == list(oa)
        for key in ra:
            if key in ("text_embedding_before", "blip_clip_embeddings") and ra[key]:
                a = np.frombuffer(base64.b64decode(ra[key]), np.float32)
                b = np.frombuffer(base64.b64decode(oa[key]), np.float32)
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= emb_tol * max(np.abs(a).max(), 1.0), key
            else:
                assert ra[key] == oa[key], key


def test_label_image_matches_jax_on_the_oracle(oracle, embedders):
    """label_image of every fixture image: the records key for key as JAX's,
    the `image` field (PIL's JPEG of the decoded image) byte-equal, the
    phrase embeddings of the tiny CLIP tower within 1e-5 * max |x|. Where
    NMS drops an overlapping box, JAX's oracle fails its mask count check
    (it returns every annotation's mask); the port's returns the kept
    boxes' masks, checked here against the annotations."""
    inst, _, entries = oracle
    (jpipe, jload), (ppipe, pload) = _pipelines(inst, *embedders)
    jax_failed = 0
    for entry in entries:
        name = os.path.splitext(os.path.basename(entry["image"]))[0]
        out = ppipe.label_image(pload(entry["image"]), entry["caption"], name)
        try:
            ref = jpipe.label_image(jload(entry["image"]), entry["caption"], name)
        except AssertionError:
            jax_failed += 1
            _check_kept_masks(inst, entry, out)
            continue
        _same_record(ref, out, EMB_TOL)
        assert len(np.frombuffer(base64.b64decode(out["annos"][0]["text_embedding_before"]),
                                 np.float32)) == 32
    assert 0 < jax_failed < len(entries)
    je, pe = embedders
    assert sorted(je._cache) == sorted(pe._cache)  # the same memo


def _check_kept_masks(inst, entry, rec):
    """Each anno of the record is an annotation of its image: its mask is
    the annotation's mask, its bbox the annotation's, fewer annos than
    annotations (NMS dropped some)."""
    from instancediffusion_tpu_torch.data import geometry as geo
    from instancediffusion_tpu_torch.evalsuite.coco_eval import CocoAnnotations

    coco = CocoAnnotations(inst)
    img_id = next(i for i, im in coco.imgs.items()
                  if im["file_name"] == os.path.basename(entry["image"]))
    anns = [a for a in coco.img_anns[img_id] if not a.get("iscrowd", 0)]
    assert 0 < len(rec["annos"]) < len(anns)
    for anno in rec["annos"]:
        x, y, w, h = anno["bbox"]
        match = [a for a in anns if [int(a["bbox"][0]), int(a["bbox"][1]),
                                     int(a["bbox"][0] + a["bbox"][2]) - int(a["bbox"][0]),
                                     int(a["bbox"][1] + a["bbox"][3]) - int(a["bbox"][1])]
                 == [x, y, w, h]]
        assert match, anno["bbox"]
        want = coco.ann_to_mask(match[0], coco.imgs[img_id])[:, :, 0]
        np.testing.assert_array_equal(geo.rle_decode(anno["mask"])[:, :, 0], want)


def test_run_resumes_and_shards_as_jax(oracle, tmp_path):
    """run() over two job shards with the zero embedder: the same files as
    JAX's, every record equal; a second run rewrites nothing. NMS at IoU 1.0
    keeps every box, so JAX's oracle passes its mask count check (the test
    above covers dropped boxes)."""
    inst, _, entries = oracle
    (jpipe, jload), (ppipe, pload) = _pipelines(inst, jb.zero_phrase_embedder,
                                                pb.zero_phrase_embedder, iou_threshold=1.0)
    for j in range(2):
        wj = jpipe.run(entries, str(tmp_path / "jax"), num_jobs=2, job_index=j, load_image=jload)
        wp = ppipe.run(entries, str(tmp_path / "port"), num_jobs=2, job_index=j,
                       load_image=pload)
        assert [os.path.basename(p) for p in wj] == [os.path.basename(p) for p in wp]
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == len(entries)
    for name in names:
        _same_record(json.loads((tmp_path / "jax" / name).read_text()),
                     json.loads((tmp_path / "port" / name).read_text()))
    mtimes = {n: os.path.getmtime(tmp_path / "port" / n) for n in names}
    again = ppipe.run(entries, str(tmp_path / "port"), load_image=pload)
    assert len(again) == len(entries)
    assert {n: os.path.getmtime(tmp_path / "port" / n) for n in names} == mtimes


def test_label_main_and_the_loader(oracle, tmp_path):
    """label.main with --write_train_txt (zero embedder, NMS at IoU 1.0 as
    above): JAX's files and train.txt lines; the port's JsonDataset reads a
    record."""
    inst, entries_json, entries = oracle
    args = ["--train_data_path", entries_json, "--instances_json", inst, "--write_train_txt",
            "--iou_threshold", "1.0"]
    jl.main(args + ["--output_dir", str(tmp_path / "jax")])
    written = pl.main(args + ["--output_dir", str(tmp_path / "port")])
    assert len(written) == len(entries)
    lines = (tmp_path / "port" / "train.txt").read_text().splitlines()
    ref = (tmp_path / "jax" / "train.txt").read_text().splitlines()
    assert [os.path.basename(p) for p in lines] == [os.path.basename(p) for p in ref]
    ds = JsonDataset(str(tmp_path / "port" / "train.txt"),
                     SampleDecoder(image_size=64, max_boxes_per_data=4))
    item = ds[0]
    assert item["image"].shape == (64, 64, 3) and int(item["text_masks"].sum()) > 0


def test_coco_to_training_jsons_matches_the_tool(oracle, tmp_path, monkeypatch):
    """The port's converter writes the JAX tool's records (zero embedder)
    and train.txt; the port's JsonDataset reads them."""
    inst, _, _ = oracle
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import coco_to_training_jsons as tool

    base = ["--instances", inst, "--images_dir", chip_smoke.FIXTURE_DIR, "--limit", "6"]
    monkeypatch.setattr(sys, "argv", ["tool"] + base + ["--out", str(tmp_path / "jax")])
    tool.main()
    listing = pc2t.main(base + ["--out", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(listing) == 6
    for name in names:
        if name.endswith(".json"):
            assert json.loads((tmp_path / "port" / name).read_text()) == \
                json.loads((tmp_path / "jax" / name).read_text()), name
    assert [os.path.basename(p) for p in
            (tmp_path / "port" / "train.txt").read_text().splitlines()] == \
        [os.path.basename(p) for p in (tmp_path / "jax" / "train.txt").read_text().splitlines()]
    ds = JsonDataset(str(tmp_path / "port" / "train.txt"),
                     SampleDecoder(image_size=64, max_boxes_per_data=4))
    assert ds[0]["image"].shape == (64, 64, 3)
    with pytest.raises(FileNotFoundError):
        pc2t.main(base + ["--out", str(tmp_path / "x"), "--ckpt", str(tmp_path / "none.pth")])


def test_encode_phrases_matches_jax(embedders):
    """encode_phrases: one batched encode, JAX's pooled features."""
    je, pe = embedders
    phrases = ["a dog", "a red kite in the sky", "bench"]
    ref = je._pipe.encode_phrases(phrases)
    out = pe._pipe.encode_phrases(phrases)
    assert len(out) == 3 and out[0].dtype == np.float32
    for a, b in zip(ref, out):
        assert np.abs(np.asarray(a) - b).max() <= EMB_TOL * max(np.abs(np.asarray(a)).max(), 1.0)
    assert pe._pipe.encode_phrases([]) == []


def test_embedder_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pb.ClipPhraseEmbedder(str(tmp_path / "any.pth"))
