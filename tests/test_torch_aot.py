"""The port's program cache (`instancediffusion_tpu_torch/aot.py`,
`pipeline.enable_aot`) on the CPU, against JAX's `aot.py` behaviour:

  * variant resolution: the same call reuses its variant; every Python value
    a capture freezes (steps, the gate schedule of alpha, guidance scale,
    the batch, the trajectory count of a phrase count under MIS, the
    sampler, img2img's start step) makes a new one, named after its sampler
    as JAX names its blobs (`plms-<hash>`, `dpm-<hash>`);
  * images under enable_aot bit-equal to the images without it (on the CPU
    there is no graph: the variant resolves and the program runs), and
    within one uint8 level of JAX's `generate` on the same bridged weights;
  * the kept kernel library with a stub compiler (a C file with the
    library's symbols, compiled by the host's cc): save, load on a fresh
    cache, a copy of the library this process loaded, a truncated file and
    one missing a symbol rebuilt and counted in `fallbacks`, two processes
    saving at once, a missing nvcc raising, and without nvcc the library
    some nvcc built taken.

Capture and replay need the card (`tests/test_torch_cuda.py`).
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import instancediffusion_tpu.data.grounding_input as gi
from instancediffusion_tpu.pipeline import InstanceDiffusionPipeline as JaxPipeline
from instancediffusion_tpu.pipeline import PipelineParams
from instancediffusion_tpu_torch import aot
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.kernels import _build
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests.test_pipeline import META, tiny_config
from tests.test_torch_bridge import dense_params, port_config, to_jax

STEPS = 4


def _meta(cfg, n_phrases=2):
    """META at the tiny config's widths with its first n_phrases instances
    and no alpha_type (so `alpha` sets the gate schedule)."""
    g = cfg.model.grounding_tokenizer
    m = dict(META, scribbles=[[0.2] * (g.n_scribble_points * 2)] * 2,
             polygons=[[0.3] * (g.n_polygon_points * 2)] * 2, segs=None)
    del m["alpha_type"]
    return {k: (v[:n_phrases] if isinstance(v, list) else v) for k, v in m.items()}


@pytest.fixture(scope="module")
def port_pipe():
    """A tiny fp32 port pipeline with the VAE encoder, densified weights."""
    cfg = port_config(tiny_config())
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=0, device="cpu",
                                                 dtype=torch.float32, vae_encoder=True)
    for i, m in enumerate((pipe.unet, pipe.vae, pipe.clip)):
        chip_smoke.densify_(m, i + 1)
    return pipe


def _twin(pipe):
    return InstanceDiffusionPipeline(pipe.cfg, pipe.unet, pipe.vae, pipe.clip, pipe.tokenizer)


BASE = dict(num_images=2, steps=STEPS, mis=0.0, seed=1)

# calls that differ from BASE in one value a capture freezes
NEW_VARIANT = {
    "steps": dict(BASE, steps=5),
    "alpha": dict(BASE, alpha=0.5),            # gates 1 1 0 0 against 1 1 1 0
    "guidance_scale": dict(BASE, guidance_scale=5.0),
    "batch": dict(BASE, num_images=1),
    "sampler_dpm": dict(BASE, sampler="dpm"),
    "sampler_ddim": dict(BASE, sampler="ddim"),
    "mis": dict(BASE, mis=0.5),
}


def test_same_call_reuses_its_variant(port_pipe, tmp_path):
    pipe = _twin(port_pipe)
    pipe.enable_aot(str(tmp_path))
    meta = _meta(pipe.cfg)
    a = pipe.generate(meta, **BASE)
    b = pipe.generate(meta, **dict(BASE, seed=2))  # other noise, same program
    [name] = pipe._aot.variants
    assert name.startswith("plms-")
    assert not np.array_equal(a, b)
    # the other inputs of the program (grounding rows) change under one
    # variant at mis=0: a phrase count is no Python value of the capture
    c = pipe.generate(_meta(pipe.cfg, 1), **BASE)
    assert list(pipe._aot.variants) == [name]
    np.testing.assert_array_equal(c, port_pipe.generate(_meta(pipe.cfg, 1), **BASE))
    manifest = json.loads((tmp_path / f"{name}.json").read_text())
    assert manifest["name"] == name and "(2, 8, 8, 4)" in manifest["signature"]
    assert pipe._aot.stats == {"loads": 0, "saves": 0, "fallbacks": 0, "captures": 0,
                               "replays": 0}  # a CPU pipeline: no library, no graph


@pytest.mark.parametrize("what", sorted(NEW_VARIANT))
def test_frozen_value_makes_a_new_variant(port_pipe, tmp_path, what):
    """Each changed value resolves a second variant, and its images equal
    the same call without the cache."""
    pipe = _twin(port_pipe)
    pipe.enable_aot(str(tmp_path))
    meta = _meta(pipe.cfg)
    pipe.generate(meta, **BASE)
    kwargs = NEW_VARIANT[what]
    out = pipe.generate(meta, **kwargs)
    names = list(pipe._aot.variants)
    assert len(names) == 2 and len(set(names)) == 2
    sampler = kwargs.get("sampler", "plms")
    assert names[1].startswith(f"{sampler}-")
    np.testing.assert_array_equal(out, port_pipe.generate(meta, **kwargs))
    pipe.generate(meta, **kwargs)
    assert len(pipe._aot.variants) == 2  # and that call reuses it


def test_phrase_count_under_mis_makes_a_new_variant(port_pipe, tmp_path):
    """Under MIS the trajectory count is 1 + the phrase count."""
    pipe = _twin(port_pipe)
    pipe.enable_aot(str(tmp_path))
    kw = dict(BASE, mis=0.5)
    pipe.generate(_meta(pipe.cfg, 2), **kw)
    out = pipe.generate(_meta(pipe.cfg, 1), **kw)
    assert len(pipe._aot.variants) == 2
    np.testing.assert_array_equal(out, port_pipe.generate(_meta(pipe.cfg, 1), **kw))


def test_img2img_strength_and_generate_batch_make_their_own_variants(port_pipe, tmp_path):
    pipe = _twin(port_pipe)
    pipe.enable_aot(str(tmp_path))
    meta = _meta(pipe.cfg)
    src = port_pipe.generate(meta, **BASE)[0]
    i2i = dict(num_images=2, steps=STEPS, seed=3)
    outs = [pipe.img2img(src, meta, strength=s, **i2i) for s in (0.5, 0.75, 0.5)]
    assert len(pipe._aot.variants) == 2  # start steps 2 and 1; the third reuses
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], port_pipe.img2img(src, meta, strength=0.75, **i2i))
    batch = pipe.generate_batch([meta, meta], steps=STEPS, mis=0.0, seeds=[1, 2])
    assert len(pipe._aot.variants) == 3
    np.testing.assert_array_equal(
        batch, port_pipe.generate_batch([meta, meta], steps=STEPS, mis=0.0, seeds=[1, 2]))


def test_aot_images_match_jax_generate(tmp_path):
    """enable_aot on a CPU pipeline: images bit-equal to the pipeline's
    without it, and within one uint8 level of JAX's generate on the same
    weights (fp32 summation order can move a value across a floor)."""
    cfg = tiny_config()
    trees = dense_params(cfg, seed=12)
    jpipe = JaxPipeline(cfg, PipelineParams(**{k: to_jax(v) for k, v in trees.items()}))
    ppipe = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                  dtype=torch.float32)
    load_jax_params(ppipe, **trees)
    meta = _meta(ppipe.cfg)
    mc = cfg.model
    x0 = np.random.default_rng(2).standard_normal(
        (2, mc.image_size, mc.image_size, mc.in_channels)).astype(np.float32)
    plain = ppipe.generate(meta, num_images=2, steps=STEPS, mis=0.0, initial_latents=x0)
    ppipe.enable_aot(str(tmp_path))
    out = ppipe.generate(meta, num_images=2, steps=STEPS, mis=0.0, initial_latents=x0)
    np.testing.assert_array_equal(out, plain)
    g = cfg.model.grounding_tokenizer
    old = (gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE)
    gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = (
        g.n_scribble_points, g.n_polygon_points, g.seg_resize_input)
    try:
        ref = jpipe.generate(meta, num_images=2, steps=STEPS, mis=0.0,
                             compute_dtype=jnp.float32, initial_latents=x0)
    finally:
        gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = old
    assert int(ref.max()) - int(ref.min()) > 10
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# the kept kernel library, with a stub compiler
# ---------------------------------------------------------------------------

CAPABILITY = (9, 0)


def _stub_source(skip: str | None = None) -> str:
    """C source exporting every function the port binds (each returns 0)."""
    names = [n for n in _build._SIGNATURES if n != skip]
    lines = [f"int {n}(void) {{ return 0; }}" for n in names]
    lines += ['const char* idt_error_string(int e) { return "stub"; }',
              "double idt_flash_encode_us(void) { return 0.0; }",
              "double idt_flash_bwd_encode_us(void) { return 0.0; }"]
    return "\n".join(lines) + "\n"


def _cc(src: str, out) -> None:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler for the stub library")
    c = str(out) + ".c"
    with open(c, "w") as f:
        f.write(src)
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(out), c], check=True)


@pytest.fixture()
def stub(monkeypatch, tmp_path):
    """_build with its compiler replaced by the stub and no library loaded;
    returns the list of compile calls (their out_dir)."""
    lib = tmp_path / "stub_src" / "libstub.so"
    lib.parent.mkdir()
    _cc(_stub_source(), lib)
    calls = []

    def compile_library(out_dir):
        calls.append(out_dir)
        tmp = _build.tempfile.mkdtemp(dir=out_dir)
        dst = os.path.join(tmp, _build.LIB_NAME)
        shutil.copyfile(lib, dst)
        return _build.Path(dst), 0.5

    monkeypatch.setattr(_build, "compile_library", compile_library)
    monkeypatch.setattr(_build, "nvcc_version", lambda: "stub nvcc, release 0.0")
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "LIB_PATH", None)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    return calls


def _fresh(directory):
    _build._LIB = None
    _build.LIB_PATH = None
    return aot.AOTProgramCache(str(directory))


def test_library_saved_then_loaded_by_a_fresh_cache(stub, tmp_path):
    d = tmp_path / "cache"
    c1 = _fresh(d)
    path = c1.ensure_library(CAPABILITY)
    assert c1.stats["saves"] == 1 and c1.stats["loads"] == 0 and len(stub) == 1
    assert path.name.startswith(aot.LIB_PREFIX) and path.exists()
    assert _build.loaded() and _build.lib().idt_head_max_clusters(1, 1, 1) == 0
    assert not [p for p in os.listdir(d) if p.endswith(".tmp") or (d / p).is_dir()]
    c2 = _fresh(d)
    assert c2.ensure_library(CAPABILITY) == path
    assert c2.stats == {"loads": 1, "saves": 0, "fallbacks": 0, "captures": 0, "replays": 0}
    assert len(stub) == 1 and _build.BUILD_INFO["seconds"] == 0.0
    # another card or another nvcc keys another file
    assert c2.library_path((8, 0)) != path


def test_library_loaded_in_process_is_copied_once(stub, tmp_path):
    _fresh(tmp_path / "a").ensure_library(CAPABILITY)
    loaded_from = _build.LIB_PATH
    c = aot.AOTProgramCache(str(tmp_path / "b"))  # the library stays loaded
    path = c.ensure_library(CAPABILITY)
    assert c.stats["saves"] == 1 and c.stats["loads"] == 0 and len(stub) == 1
    assert path.read_bytes() == loaded_from.read_bytes()
    c.ensure_library(CAPABILITY)
    assert c.stats["saves"] == 1


@pytest.mark.parametrize("damage", ["truncated", "missing_symbol"])
def test_library_that_will_not_load_is_rebuilt(stub, tmp_path, damage):
    d = tmp_path / "cache"
    path = _fresh(d).ensure_library(CAPABILITY)
    good = path.read_bytes()
    path.unlink()  # a new file: the old one stays mapped in this process
    if damage == "truncated":
        path.write_bytes(good[:4096])
    else:
        _cc(_stub_source(skip="idt_geglu_ff"), path)
    c = _fresh(d)
    assert c.ensure_library(CAPABILITY) == path
    assert c.stats["fallbacks"] == 1 and c.stats["saves"] == 1 and c.stats["loads"] == 0
    assert len(stub) == 2 and "rebuilt" in c.errors[0]
    assert path.read_bytes() == good and _build.lib().idt_geglu_ff is not None
    assert _build.BUILD_INFO["seconds"] > 0


def test_missing_nvcc_raises_and_a_kept_library_still_loads(monkeypatch, tmp_path):
    """Without nvcc and nothing kept, ensure_library raises (no plain
    fallback); a library some nvcc built for these sources is taken."""
    stub_lib = tmp_path / "libstub.so"
    _cc(_stub_source(), stub_lib)  # before `which` stops finding compilers
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "LIB_PATH", None)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(_build, "_NVCC_VERSION", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    c = aot.AOTProgramCache(str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        c.ensure_library(CAPABILITY)
    assert not _build.loaded()
    kept = tmp_path / "cache" / f"{aot.LIB_PREFIX}{c.library_base(CAPABILITY)}-0123abcd.so"
    shutil.copyfile(stub_lib, kept)
    assert c.ensure_library(CAPABILITY) == kept
    assert c.stats["loads"] == 1 and _build.LIB_PATH == kept


SAVER = textwrap.dedent("""
    import os, shutil, sys, time
    from instancediffusion_tpu_torch import aot
    from instancediffusion_tpu_torch.kernels import _build
    src, directory = sys.argv[1], sys.argv[2]
    def compile_library(out_dir):
        tmp = _build.tempfile.mkdtemp(dir=out_dir)
        dst = os.path.join(tmp, _build.LIB_NAME)
        shutil.copyfile(src, dst)
        time.sleep(1.0)  # both processes hold a finished library before either renames
        return _build.Path(dst), 1.0
    _build.compile_library = compile_library
    _build.nvcc_version = lambda: "stub nvcc, release 0.0"
    c = aot.AOTProgramCache(directory)
    c.ensure_library((9, 0))
    print(c.stats["saves"], c.stats["loads"])
""")


def test_two_processes_save_at_once(tmp_path):
    """Two processes building into one directory: each renames a whole file
    into place, the survivor loads, and no temporary file is left."""
    lib = tmp_path / "libstub.so"
    _cc(_stub_source(), lib)
    d = tmp_path / "cache"
    d.mkdir()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    procs = [subprocess.Popen([sys.executable, "-c", SAVER, str(lib), str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for _ in range(2)]
    t0 = time.perf_counter()
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert [o.split() for o, _ in outs] == [["1", "0"], ["1", "0"]]
    assert time.perf_counter() - t0 < 60
    left = sorted(os.listdir(d))
    assert len(left) == 1 and left[0].startswith(aot.LIB_PREFIX), left
    ctypes.CDLL(str(d / left[0])).idt_layer_norm  # loads, with its symbols
