"""Training dataset: per-image JSON records -> grounding training batches
(counterpart of `instancediffusion_tpu/data/jsondataset.py`, copied, with
PIL replaced: images decode through `data/jpeg.decode_image` and resize
through `data/resample.resize`, both bit for bit as PIL).

Reference pipeline (dataset/jsondataset.py:7-49 + dataset/decode_item.py):
`train.txt` lists one JSON file per image; each JSON holds a base64 image,
a caption, and `annos[]` with bbox (xywh pixels), RLE mask, per-instance
caption, and a precomputed base64 CLIP text embedding
(`text_embedding_before`, optionally `blip_clip_embeddings`).

Per-sample decode (decode_item.py:284-317 + decode.__call__ :575-764):
  1. base64 -> RGB array; base64 -> float32 phrase embeddings; RLE -> masks
  2. sample 20 scribble points + 256 sparse mask points per instance
  3. BOX-downsample + bicubic resize so min side = image_size, center crop
     (seg masks ride along with NEAREST), optional horizontal flip
  4. recalculate boxes/scribbles/polygons under scale+crop+flip, drop boxes
     that fall outside or below min_box_size (base_dataset.py:39-123)
  5. keep the max_boxes_per_data largest instances by area
  6. random BLIP-embedding swap; caption kept with prob_use_caption
  7. emit fixed-shape float32 tensors ready for device transfer

All randomness flows through an explicit np.random.Generator (seeded per
(epoch, index)) so any sample is reproducible — replacing the reference's
global random state.

Batches are plain numpy dicts; `Prefetcher` overlaps host decode with device
compute (the DataLoader-worker equivalent on a thin host).
"""

from __future__ import annotations

import atexit
import base64
import collections
import itertools
import json
import os
import multiprocessing
import queue
import signal
import threading

import numpy as np

from instancediffusion_tpu_torch.data import geometry as geo
from instancediffusion_tpu_torch.data import resample
from instancediffusion_tpu_torch.data.jpeg import decode_image

EMBEDDING_LEN = 768
N_SCRIBBLE = 20
N_POLYGON = 256


def decode_base64_image(image_b64: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a base64 JPEG or PNG."""
    return decode_image(base64.b64decode(image_b64))


def decode_embedding(arr_str: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(arr_str), dtype=np.float32)


# ---------------------------------------------------------------------------
# Geometry under scale/crop/flip (base_dataset.py:39-123)
# ---------------------------------------------------------------------------


def recalc_box(x, y, w, h, info, image_size, min_box_size):
    s = info["performed_scale"]
    x0 = x * s - info["crop_x"]
    y0 = y * s - info["crop_y"]
    x1 = (x + w) * s - info["crop_x"]
    y1 = (y + h) * s - info["crop_y"]
    if x0 > image_size or y0 > image_size or x1 < 0 or y1 < 0:
        return False, None
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, image_size), min(y1, image_size)
    if (x1 - x0) * (y1 - y0) / (image_size**2) < min_box_size:
        return False, None
    if info["performed_flip"]:
        x0, x1 = image_size - x1, image_size - x0
    return True, (x0, y0, x1, y1)


def recalc_points(flat_xy, info, image_size):
    s = info["performed_scale"]
    out = np.asarray(flat_xy, np.float32).reshape(-1, 2).copy()
    out[:, 0] = np.clip(out[:, 0] * s - info["crop_x"], 0, image_size)
    out[:, 1] = np.clip(out[:, 1] * s - info["crop_y"], 0, image_size)
    if info["performed_flip"]:
        out[:, 0] = image_size - out[:, 0]
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Captions from detection data (decode_item.py:357-385,741-762)
# ---------------------------------------------------------------------------

# NLTK stop-word list as hardcoded by the reference (decode_item.py:752)
STOP_WORDS = frozenset(
    "i me my myself we our ours ourselves you you're you've you'll you'd "
    "your yours yourself yourselves he him his himself she she's her hers "
    "herself it it's its itself they them their theirs themselves what "
    "which who whom this that that'll these those am is are was were be "
    "been being have has had having do does did doing a an the and but if "
    "or because as until while of at by for with about against between "
    "into through during before after above below to from up down in out "
    "on off over under again further then once here there when where why "
    "how all any both each few more most other some such no nor not only "
    "own same so than too very s t can will just don don't should "
    "should've now d ll m o re ve y ain aren aren't couldn couldn't didn "
    "didn't doesn doesn't hadn hadn't hasn hasn't haven haven't isn isn't "
    "ma mightn mightn't mustn mustn't needn needn't shan shan't shouldn "
    "shouldn't wasn wasn't weren weren't won won't wouldn wouldn't".split()
)


def make_a_sentence_count_nums(obj_names: list[str]) -> str:
    """'2 dog, 1 cat' from ['dog','dog','cat'] (decode_item.py:357-365)."""
    counts: dict[str, int] = {}
    for n in obj_names:
        counts[n] = counts.get(n, 0) + 1
    return ", ".join(f"{v} {k}" for k, v in counts.items())


def make_a_sentence(obj_names: list[str], clean: bool = False) -> str:
    """'dog, dog, cat' (decode_item.py:368-385)."""
    if clean:
        obj_names = [
            n[:-6] if "-other" in n else n for n in obj_names
        ]
    return ", ".join(obj_names)


def remove_stop_words(caption: str) -> str:
    """Stop-word filtering applied when instance captions are appended to
    the global caption (decode_item.py:750-754)."""
    return " ".join(
        w for w in caption.split() if w.lower() not in STOP_WORDS
    )


def random_drop_embedding_masks(
    masks: np.ndarray, mode: str, rng: np.random.Generator
):
    """Random text/image embedding dropout (decode_item.py:388-420):
    'both' drops image OR text per valid token with p=0.5 (never both);
    'image' drops image features per token with p=0.5, keeps text."""
    n = masks.shape[0]
    if mode == "both":
        temp = np.ones((2, n), np.float32)
        for i in range(n):
            if rng.random() < 0.5:
                temp[int(rng.integers(0, 2)), i] = 0.0
        return temp[0] * masks, temp[1] * masks
    if mode == "image":
        return masks * (rng.random(n) > 0.5).astype(np.float32), masks
    return masks, masks


def rasterize_att_mask(box01: np.ndarray, size: int = 64) -> np.ndarray:
    """64x64 box raster for masked instance attention (decode_item.py:699-703).
    Rows indexed by x, cols by y — the reference's att_masks[x1:x2, y1:y2]
    quirk, reproduced (matches ops/instance_mask.rasterize_boxes)."""
    m = np.zeros((size, size), np.float32)
    x1, y1, x2, y2 = np.round(np.asarray(box01) * size).astype(int)
    m[x1:x2, y1:y2] = 1.0
    return m


# ---------------------------------------------------------------------------
# Image transform (decode_item.py:767-804 + decode.transform_image :553-573)
# ---------------------------------------------------------------------------


def _size(arr: np.ndarray) -> tuple[int, int]:
    """(width, height), as PIL's Image.size."""
    return arr.shape[1], arr.shape[0]


def _resize_segs(segs: np.ndarray, new: tuple[int, int], method: str) -> np.ndarray:
    return np.stack([resample.resize(s, new, method) for s in segs])


def random_crop_image(
    image: np.ndarray, image_size: int, segs: np.ndarray | None,
    rng: np.random.Generator, min_crop_frac: float = 0.8,
    max_crop_frac: float = 1.0,
):
    """random_crop_arr (decode_item.py:807-828) extended to return the
    trans_info and carry segs — the reference's random_crop branch is dead
    (`assert False`, decode_item.py:555); this is the working equivalent."""
    import math

    ww, hh = _size(image)
    min_s = math.ceil(image_size / max_crop_frac)
    max_s = math.ceil(image_size / min_crop_frac)
    smaller = int(rng.integers(min_s, max_s + 1))

    while min(_size(image)) >= 2 * smaller:
        new = tuple(x // 2 for x in _size(image))
        image = resample.resize(image, new, resample.BOX)
        if segs is not None:
            segs = _resize_segs(segs, new, resample.BOX)
    scale = smaller / min(_size(image))
    new = tuple(round(x * scale) for x in _size(image))
    image = resample.resize(image, new, resample.BICUBIC)
    if segs is not None:
        segs = _resize_segs(segs, new, resample.NEAREST)
    arr = image
    crop_y = int(rng.integers(0, arr.shape[0] - image_size + 1))
    crop_x = int(rng.integers(0, arr.shape[1] - image_size + 1))
    info = {
        "performed_scale": smaller / min(ww, hh),
        "crop_y": crop_y,
        "crop_x": crop_x,
        "performed_flip": False,
    }
    arr = arr[crop_y : crop_y + image_size, crop_x : crop_x + image_size]
    if segs is not None:
        segs = segs[:, crop_y : crop_y + image_size, crop_x : crop_x + image_size]
    return arr, info, segs


def center_crop_image(image: np.ndarray, image_size: int, segs: np.ndarray | None):
    """Progressive BOX halving + bicubic to min-side=image_size + center
    crop; segs (N, H, W) ride along with NEAREST."""
    ww, hh = _size(image)
    while min(_size(image)) >= 2 * image_size:
        new = tuple(x // 2 for x in _size(image))
        image = resample.resize(image, new, resample.BOX)
        if segs is not None:
            segs = _resize_segs(segs, new, resample.BOX)
    scale = image_size / min(_size(image))
    new = tuple(round(x * scale) for x in _size(image))
    image = resample.resize(image, new, resample.BICUBIC)
    if segs is not None:
        segs = _resize_segs(segs, new, resample.NEAREST)
    arr = image
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    info = {
        "performed_scale": image_size / min(ww, hh),
        "crop_y": crop_y,
        "crop_x": crop_x,
        "performed_flip": False,
    }
    arr = arr[crop_y : crop_y + image_size, crop_x : crop_x + image_size]
    if segs is not None:
        segs = segs[:, crop_y : crop_y + image_size, crop_x : crop_x + image_size]
    return arr, info, segs


# ---------------------------------------------------------------------------
# Sample decoder
# ---------------------------------------------------------------------------


class SampleDecoder:
    """decode.__call__ (decode_item.py:575-764) with explicit RNG."""

    def __init__(
        self,
        image_size: int = 512,
        max_boxes_per_data: int = 30,
        min_box_size: float = 0.01,
        prob_use_caption: float = 1.0,
        random_flip: bool = True,
        random_blip: float = 0.0,
        random_crop: bool = False,
        random_drop_embedding: str = "none",   # none | both | image
        return_att_masks: bool = False,
        count_dups_make_a_sentence: bool = False,
        add_inst_cap_2_global: bool = False,
    ):
        assert random_drop_embedding in ("none", "both", "image")
        self.image_size = image_size
        self.max_boxes = max_boxes_per_data
        self.min_box_size = min_box_size
        self.prob_use_caption = prob_use_caption
        self.random_flip = random_flip
        self.random_blip = random_blip
        self.random_crop = random_crop
        self.random_drop_embedding = random_drop_embedding
        self.return_att_masks = return_att_masks
        self.count_dups_make_a_sentence = count_dups_make_a_sentence
        self.add_inst_cap_2_global = add_inst_cap_2_global

    def __call__(self, raw: dict, rng: np.random.Generator) -> dict:
        image = decode_base64_image(raw["image"])

        # per-anno mask decode + point sampling (decode_item.py:284-317)
        seg_list = []
        annos = raw["annos"]
        for anno in annos:
            if "mask" in anno and anno["mask"]:
                m = geo.rle_decode(anno["mask"]).astype(np.uint8)
                seg_list.append(m[:, :, 0])
                if "scribbles" not in anno:
                    anno["scribbles"] = geo.sample_random_points_from_mask(
                        m, N_SCRIBBLE, rng
                    )
                poly = geo.sample_sparse_points_from_mask(m, N_POLYGON, rng)
                anno["polygons"] = (
                    poly if poly is not None else [0.0] * (N_POLYGON * 2)
                )
        segs = np.stack(seg_list) if seg_list else None

        if self.random_crop:
            arr, info, segs_tf = random_crop_image(
                image, self.image_size, segs, rng
            )
        else:
            arr, info, segs_tf = center_crop_image(image, self.image_size, segs)
        if self.random_flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
            info["performed_flip"] = True
            if segs_tf is not None:
                segs_tf = np.flip(segs_tf, axis=2).copy()
        image_arr = arr.astype(np.float32) / 127.5 - 1.0  # (H, W, 3) NHWC

        is_det = bool(raw.get("is_det", False))  # decode_item.py:577
        s = self.image_size
        # (area, box01, point01, scribble01, polygon01, seg, emb, cat, ocap)
        kept = []
        seg_idx = 0
        for anno in annos:
            has_mask = "mask" in anno and anno["mask"]
            this_seg_idx = seg_idx
            if has_mask:
                seg_idx += 1
            x, y, w, h = anno["bbox"]
            valid, box = recalc_box(x, y, w, h, info, s, self.min_box_size)
            if not valid:
                continue
            x0, y0, x1, y1 = box
            if "scribbles" in anno:
                scr = recalc_points(anno["scribbles"], info, s) / s
            else:
                scr = np.zeros(N_SCRIBBLE * 2, np.float32)
            if "polygons" in anno:
                poly = recalc_points(anno["polygons"], info, s) / s
                seg = (
                    segs_tf[this_seg_idx].astype(np.float32)
                    if segs_tf is not None
                    else np.zeros((s, s), np.float32)
                )
            else:
                poly = np.zeros(N_POLYGON * 2, np.float32)
                seg = np.zeros((s, s), np.float32)
            if (
                "blip_clip_embeddings" in anno
                and rng.random() < self.random_blip
            ):
                emb = decode_embedding(anno["blip_clip_embeddings"])
            else:
                emb = decode_embedding(anno["text_embedding_before"])
            # detection data: category names drive the pseudo caption,
            # per-instance captions ride along (decode_item.py:655-663)
            cat = anno.get("category_name", "") if is_det else ""
            if is_det and "caption" in anno:
                ocap = f"{cat}, {anno['caption']}"
            else:
                ocap = ""
            kept.append(
                (
                    (x1 - x0) * (y1 - y0),
                    np.asarray([x0, y0, x1, y1], np.float32) / s,
                    np.asarray([(x0 + x1) / 2, (y0 + y1) / 2], np.float32) / s,
                    scr.astype(np.float32),
                    poly.astype(np.float32),
                    seg,
                    emb,
                    cat,
                    ocap,
                )
            )

        # largest-N by area (decode_item.py:667-669)
        kept.sort(key=lambda t: -t[0])
        kept = kept[: self.max_boxes]

        n = self.max_boxes
        out = {
            "image": image_arr,
            "boxes": np.zeros((n, 4), np.float32),
            "points": np.zeros((n, 2), np.float32),
            "masks": np.zeros((n,), np.float32),
            "scribbles": np.zeros((n, N_SCRIBBLE * 2), np.float32),
            "polygons": np.zeros((n, N_POLYGON * 2), np.float32),
            "segs": np.zeros((n, s, s), np.float32),
            "text_embeddings": np.zeros((n, EMBEDDING_LEN), np.float32),
        }
        if self.return_att_masks:
            out["att_masks"] = np.zeros((n, 64, 64), np.float32)
        category_names: list[str] = []
        obj_captions: list[str] = [""] * n
        for i, (_, box, pt, scr, poly, seg, emb, cat, ocap) in enumerate(kept):
            out["boxes"][i] = box
            out["points"][i] = pt
            out["masks"][i] = 1.0
            out["scribbles"][i] = scr
            out["polygons"][i] = poly
            out["segs"][i] = seg
            out["text_embeddings"][i][: len(emb)] = emb
            if is_det:
                category_names.append(cat)
                obj_captions[i] = ocap
            if self.return_att_masks:
                out["att_masks"][i] = rasterize_att_mask(box)

        # random text/image embedding dropout (decode_item.py:705-709)
        image_masks, text_masks = random_drop_embedding_masks(
            out["masks"], self.random_drop_embedding, rng
        )
        out["image_masks"] = image_masks
        out["text_masks"] = text_masks
        out["obj_captions"] = obj_captions

        # Per-instance mini-batches for MIS training (the reference's
        # instance_meta, decode_item.py:724-739) are NOT materialized: every
        # field is a row of the arrays above (boxes[i], points[i], segs[i],
        # text_embeddings[i], caption=obj_captions[i], masks=1) —
        # grounding_input.instance_grounding_from_batch reassembles the
        # padded single-instance grounding dict without duplicating ~30x
        # 512x512 seg rasters per sample.

        # global caption (decode_item.py:741-763)
        use_caption = rng.random() < self.prob_use_caption
        if use_caption:
            if is_det:
                caption = (
                    make_a_sentence_count_nums(category_names)
                    if self.count_dups_make_a_sentence
                    else make_a_sentence(category_names)
                )
                if "caption" in raw:
                    caption = f"{caption}. {raw['caption']}"
                if self.add_inst_cap_2_global:
                    for ocap in obj_captions:
                        if ocap:
                            caption = remove_stop_words(f"{caption}. {ocap}")
                out["caption"] = caption
            else:
                out["caption"] = raw.get("caption", "")
        else:
            out["caption"] = ""
        out["caption_mask"] = np.float32(1.0 if use_caption else 0.0)
        return out


# ---------------------------------------------------------------------------
# Dataset + loader
# ---------------------------------------------------------------------------


class JsonDataset:
    """dataset/jsondataset.py:7-49: a txt file listing per-image JSONs."""

    def __init__(self, list_file: str, decoder: SampleDecoder, seed: int = 0):
        with open(list_file) as f:
            self.files = [l.strip() for l in f if l.strip()]
        base = os.path.dirname(os.path.abspath(list_file))
        self.files = [
            f if os.path.isabs(f) else os.path.join(base, f) for f in self.files
        ]
        self.decoder = decoder
        self.seed = seed

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        with open(self.files[idx]) as f:
            raw = json.load(f)
        rng = np.random.default_rng((self.seed, epoch, idx))
        return self.decoder(raw, rng)


def collate(samples: list[dict], tokenizer=None, max_len: int = 77,
            keep_caption: bool = False) -> dict:
    """Stack samples; tokenize captions to ids for the on-device CLIP.
    keep_caption=True additionally carries the raw caption strings (host-only
    consumers like the sample-grid saver; never device_put such a batch)."""
    # stack only numeric leaves: string fields (caption) and string LISTS
    # (obj_captions) must never become numpy unicode arrays — device_put
    # on such a batch raises on the first training step
    batch = {
        k: np.stack([s[k] for s in samples])
        for k in samples[0]
        if isinstance(samples[0][k], (np.ndarray, np.generic, int, float))
    }
    if tokenizer is not None:
        batch["caption_ids"] = np.stack(
            [tokenizer.encode(s["caption"], max_len) for s in samples]
        )
    if keep_caption:
        batch["caption"] = [s["caption"] for s in samples]
        batch["obj_captions"] = [s.get("obj_captions", []) for s in samples]
    return batch


_WORKER_DATASET: JsonDataset | None = None  # a decode process's own dataset

# a scheduler's preemption signals (Slurm's scancel and --signal=USR1 reach
# every process of the job) and a terminal's interrupt
PREEMPT_SIGNALS = (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1)
CLOSE_WAIT_S = 30.0  # Prefetcher.close: how long the decode processes get to end


def _init_worker(dataset: JsonDataset, closing) -> None:
    """A decode process's set-up. The training process acts on a preemption
    signal (it finishes its step, saves and exits), and it may need a batch
    to get there, so a decode process ignores SIGINT and SIGUSR1 and ends on
    SIGTERM only once its Prefetcher is closing (`closing` set) or its
    parent is gone. The signals stay blocked from the pool's creation
    (`Prefetcher._start_pool`) to here, so one sent while the process
    starts waits for these handlers."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    parent = os.getppid()

    def on_sigterm(signum, frame):
        if closing.value or os.getppid() != parent:
            os._exit(0)

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, on_sigterm)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, PREEMPT_SIGNALS)


def _decode_in_worker(idx_epoch: tuple[int, int]) -> dict:
    """A sample, its 0/1 instance masks sent as uint8 (a quarter of the
    bytes through the pipe; `_from_worker` restores the float32)."""
    sample = _WORKER_DATASET.__getitem__(*idx_epoch)
    segs = sample["segs"].astype(np.uint8)
    if np.array_equal(segs, sample["segs"]):
        sample["segs"] = segs
    return sample


def _from_worker(sample: dict) -> dict:
    if sample["segs"].dtype == np.uint8:
        sample["segs"] = sample["segs"].astype(np.float32)
    return sample


class Prefetcher:
    """Background-thread batch producer: overlaps host JSON/RLE decode with
    device steps (the DataLoader-workers + DistributedSampler role,
    utils/dataloader.py:6-24). Shards by (host_index, num_hosts), every
    shard giving the same number of batches (`batches_per_epoch`).

    Unlike the JAX package's, with workers > 1 the samples decode in that
    many spawned processes, up to two batches ahead (threads would share
    the interpreter lock with the training loop, which holds it most of a
    step); each sample keeps its own RNG, so batches and their order are
    those of one process. The processes leave preemption signals to the
    training process (`_init_worker`).
    With pin_memory, each numeric field of a batch comes as a torch tensor
    in pinned host memory (for a non_blocking copy to the card). A failure
    in the producer is raised in the consumer, and leaving an epoch early
    stops the producer. `close` ends the decode processes."""

    def __init__(
        self,
        dataset: JsonDataset,
        batch_size: int,
        tokenizer=None,
        shuffle: bool = True,
        depth: int = 2,
        host_index: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        workers: int = 1,
        pin_memory: bool = False,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.depth = depth
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.seed = seed
        self.workers = workers
        self.pin_memory = pin_memory
        self._pool = None

    def _samples(self, idxs: np.ndarray, epoch: int, stop: threading.Event):
        """The epoch's samples in order: decoded here with one worker, else
        by the processes, at most two batches ahead of the consumer. Ends
        early once `stop` is set."""
        if self.workers <= 1:
            for i in idxs:
                yield self.ds.__getitem__(int(i), epoch)
            return
        if self._pool is None:
            self._start_pool()
        pending: collections.deque = collections.deque()
        todo = iter(idxs)
        while True:
            while len(pending) < 2 * self.bs:
                i = next(todo, None)
                if i is None:
                    break
                pending.append(self._pool.apply_async(_decode_in_worker, ((int(i), epoch),)))
            if not pending:
                return
            while True:
                try:
                    sample = pending[0].get(timeout=0.1)
                    break
                except multiprocessing.TimeoutError:
                    if stop.is_set():
                        return
            pending.popleft()
            yield _from_worker(sample)

    def _start_pool(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        self._closing = ctx.RawValue("b", 0)
        # the processes inherit this thread's signal mask, and so do the
        # pool's threads, which start replacements: block the preemption
        # signals until `_init_worker` has set its handlers
        mask = signal.pthread_sigmask(signal.SIG_BLOCK, PREEMPT_SIGNALS)
        try:
            self._pool = ctx.Pool(self.workers, initializer=_init_worker,
                                  initargs=(self.ds, self._closing))
        finally:
            signal.pthread_sigmask(signal.SIG_SETMASK, mask)
        # close before multiprocessing's exit hook, whose SIGTERM the
        # processes would ignore
        atexit.register(self.close)

    def close(self) -> None:
        """End the decode processes (a later epoch starts new ones). The
        pool's terminate sends each process SIGTERM and waits for it without
        a bound; now and then one outlives that SIGTERM (seen under load:
        `Pool.terminate` waiting in its last join), so the wait here is
        bounded and a process still alive after it is killed."""
        if self._pool is None:
            return
        pool, self._pool = self._pool, None
        self._closing.value = 1
        ender = threading.Thread(target=pool.terminate, daemon=True, name="prefetcher-close")
        ender.start()
        ender.join(CLOSE_WAIT_S)
        if ender.is_alive():
            for proc in list(pool._pool):  # the pool's worker processes
                if proc.is_alive():
                    proc.kill()
            ender.join()
        pool.join()
        atexit.unregister(self.close)

    def batches_per_epoch(self) -> int:
        """The same on every rank: (records // num_hosts) // batch_size. JAX's
        Prefetcher takes len(its shard) // batch_size, which differs between
        hosts when the record count is not a multiple of num_hosts (14
        records at batch 2 over 4 ranks: 2, 2, 1, 1 batches), and a rank that
        runs out first leaves the others waiting in their next collective."""
        return (len(self.ds) // self.num_hosts) // self.bs

    def epoch(self, epoch: int):
        idxs = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idxs)
        idxs = idxs[self.host_index :: self.num_hosts]
        n_batches = self.batches_per_epoch()
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                samples = self._samples(idxs[: n_batches * self.bs], epoch, stop)
                for _ in range(n_batches):
                    group = list(itertools.islice(samples, self.bs))
                    if stop.is_set():
                        return
                    batch = collate(group, self.tokenizer)
                    put(pin_batch(batch) if self.pin_memory else batch)
                put(None)
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True, name=f"prefetcher-epoch{epoch}")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def pin_batch(batch: dict) -> dict:
    """A collated batch with every numpy field as a torch tensor in pinned
    host memory; other fields as they are."""
    import torch

    return {k: torch.from_numpy(v).pin_memory() if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}
