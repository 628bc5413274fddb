"""The port's native host decoder (data/native_loader.py), built from
native/vcg_host.cc with g++ and libjpeg; skipped where either is absent
(`toolchain()` decides before any build).

- decode_batch equal to the port's PIL `load_frame` at the files' size;
  decode_batch_s2d equal to PIL plus the numpy space_to_depth4;
  decode_file and normalize_f32 against numpy;
- a missing file zero-filled and counted in `failures`;
- install_native_loader routing load_clip_frames (frames and s2d) through
  the decoder, `set_native_loader(None)` putting PIL back, and raising on
  a library that cannot load (the JAX one returns False and keeps PIL).
"""

import glob
import os

import numpy as np
import pytest

from video_chapter_generation_tpu_torch.data import frames, native_loader
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)

HAVE, WHY = native_loader.toolchain()
pytestmark = pytest.mark.skipif(not HAVE, reason=f"native decoder: {WHY}")
HW = 64


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    paths = make_synth_corpus_on_disk(str(root), n_videos=1, video_sec=40,
                                      hw=HW)
    return sorted(glob.glob(os.path.join(paths["img_dir"], "**", "*.jpg"),
                            recursive=True))[:12]


@pytest.fixture(scope="module")
def loader():
    return native_loader.NativeLoader(2)


def _pil(files):
    return np.stack([frames.load_frame(f, HW) for f in files])


def test_decode_equals_pil_and_s2d_equals_numpy(jpegs, loader):
    want = _pil(jpegs)
    np.testing.assert_array_equal(loader.decode_batch(jpegs, HW), want)
    np.testing.assert_array_equal(loader.decode_batch_s2d(jpegs, HW),
                                  frames.space_to_depth4(want))
    np.testing.assert_array_equal(loader.decode_file(jpegs[3], HW), want[3])
    assert loader.failures == 0
    with pytest.raises(ValueError, match="multiple of 4"):
        loader.decode_batch_s2d(jpegs, 30)


def test_missing_file_is_zero_filled_and_counted(jpegs, tmp_path):
    loader = native_loader.NativeLoader(2)
    bad = [jpegs[0], str(tmp_path / "missing.jpg"), jpegs[1]]
    (tmp_path / "broken.jpg").write_bytes(b"not a jpeg")
    out = loader.decode_batch(bad + [str(tmp_path / "broken.jpg")], HW)
    assert loader.failures == 2
    assert not out[1].any() and not out[3].any()
    np.testing.assert_array_equal(out[[0, 2]], _pil([jpegs[0], jpegs[1]]))
    s2d = loader.decode_batch_s2d(bad, HW)
    assert loader.failures == 3 and not s2d[1].any()
    np.testing.assert_array_equal(out[1], frames.load_frame(bad[1], HW))


def test_normalize_f32(loader):
    u8 = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3), np.uint8)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    got = loader.normalize_f32(u8, mean, std)
    m, s = np.float32(mean), np.float32(std)
    want = u8 * (np.float32(1.0) / (np.float32(255.0) * s)) + (-m / s)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_install_routes_load_clip_frames(jpegs, tmp_path):
    want = _pil(jpegs)
    try:
        loader = native_loader.install_native_loader(2)
        assert frames._native_loader is not None
        np.testing.assert_array_equal(frames.load_clip_frames(jpegs, HW),
                                      want)
        np.testing.assert_array_equal(
            frames.load_clip_frames(jpegs, HW, s2d=True),
            frames.space_to_depth4(want))
        # a frame cache keeps the PIL path, as in the JAX package
        cache = frames.FrameCache()
        np.testing.assert_array_equal(
            frames.load_clip_frames(jpegs[:2], HW, cache=cache), want[:2])
        assert cache.misses == 2 and loader.failures == 0
    finally:
        frames.set_native_loader(None)
    assert frames._native_loader is None
    bad = tmp_path / "not_a_library.so"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(OSError):
        native_loader.install_native_loader(2, lib_path=str(bad))
    assert frames._native_loader is None


def test_build_is_keyed_by_the_source():
    path = native_loader.build_library()
    assert path.exists() and path.parent == native_loader.BUILD_DIR
    assert native_loader.build_library() == path  # loaded, not rebuilt
    assert native_loader.SOURCE.name == "vcg_host.cc"
