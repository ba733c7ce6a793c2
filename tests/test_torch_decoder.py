"""The port's file decoder (``tstar_tpu_torch/video/decoder.py``) against the
JAX package's ``NativeDecoder`` on a video that the reference's
``write_synthetic_video`` writes (60 s, 10 fps, 96x160, a planted couch):
the same header, and byte-equal frames from ``decode_batch`` and
``decode_sweep``, at native size and resized.  Without the library in
place the port builds it from ``native/video_decoder.cpp``; when neither
works it raises, with no other decoder to give way to.  Runs only where
cv2 imports (it writes the video), as ``tests/test_video.py``.
"""

import numpy as np
import pytest

from tstar_tpu.video.decoder import NativeDecoder as JNativeDecoder
from tstar_tpu.video.synthetic import PlantedObject, second_intensity, write_synthetic_video
from tstar_tpu_torch.video import decoder as tdec
from tstar_tpu_torch.video.synthetic import SyntheticDecoder

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("decoder") / "scene.mp4")
    write_synthetic_video(path, duration_sec=60.0, fps=10.0, hw=(96, 160), objects=[
        PlantedObject("couch", (20.0, 26.0), (200, 40, 40), (0.5, 0.5), 0.4)])
    return path


@pytest.fixture(scope="module")
def pair(video):
    ref, port = JNativeDecoder(video), tdec.open_video(video)
    yield ref, port
    ref.close()
    port.close()


def test_meta_equals_reference(pair):
    ref, port = pair
    assert port.meta == tdec.VideoMeta(ref.meta.fps, ref.meta.total_frames, ref.meta.width,
                                       ref.meta.height)
    assert port.meta.total_frames == 600 and port.meta.duration == 60.0


@pytest.mark.parametrize("out_hw", [None, (48, 80), (32, 64)])
def test_decode_batch_byte_equal(pair, out_hw):
    ref, port = pair
    idx = [0, 7, 255, 201, 599, 3]          # out of order, as a search asks
    got = port.decode_batch(idx, out_hw=out_hw)
    np.testing.assert_array_equal(got, ref.decode_batch(idx, out_hw=out_hw))
    assert got.dtype == np.uint8 and got.shape[1:3] == (out_hw or (96, 160))


@pytest.mark.parametrize("out_hw", [None, (48, 80)])
def test_decode_sweep_byte_equal(pair, out_hw):
    ref, port = pair
    got = port.decode_sweep(1.0, 60, out_hw=out_hw)
    np.testing.assert_array_equal(got, ref.decode_sweep(1.0, 60, out_hw=out_hw))
    # a second's background code, through the codec: within a few levels
    codes = got[:, 2, 2].astype(int).mean(axis=-1)
    want = np.array([second_intensity(s) for s in range(60)])
    assert np.abs(codes - want).max() <= 8


def test_batch_rows_equal_sweep_rows(pair):
    """The streaming cache's seek-decode gives the resident sweep's rows."""
    _, port = pair
    sweep = port.decode_sweep(1.0, 60, out_hw=(32, 64))
    secs = [59, 0, 13, 31, 30]
    np.testing.assert_array_equal(port.decode_batch([10 * s for s in secs], out_hw=(32, 64)),
                                  sweep[secs])


def test_short_sweep_pads_with_its_last_frame(pair):
    ref, port = pair
    got = port.decode_sweep(1.0, 70, out_hw=(32, 64))
    np.testing.assert_array_equal(got, ref.decode_sweep(1.0, 70, out_hw=(32, 64)))
    for row in got[60:]:
        np.testing.assert_array_equal(row, got[59])


def test_missing_file_raises_value_error(tmp_path):
    with pytest.raises(ValueError, match="Cannot open video file"):
        tdec.open_video(str(tmp_path / "missing.mp4"))
    (tmp_path / "empty.mp4").write_bytes(b"")
    with pytest.raises(ValueError, match="Cannot open video file"):
        tdec.open_video(str(tmp_path / "empty.mp4"))


def _fresh_library(monkeypatch, tmp_path, lib_path):
    monkeypatch.setattr(tdec, "_lib", None)
    monkeypatch.setattr(tdec, "_lib_error", None)
    monkeypatch.setattr(tdec, "LIB_PATH", lib_path)
    monkeypatch.setattr(tdec, "BUILD_DIR", tmp_path / "_build")


def test_builds_the_library_from_source_when_it_does_not_load(monkeypatch, tmp_path, video, pair):
    """No library in place: ``native/video_decoder.cpp`` is built into the
    build directory (``native/`` is not written) and decodes the same
    bytes."""
    _fresh_library(monkeypatch, tmp_path, tmp_path / "absent" / "libtstar_video.so")
    dec = tdec.open_video(video)
    try:
        assert (tmp_path / "_build" / "libtstar_video.so").exists()
        np.testing.assert_array_equal(dec.decode_batch([5, 300], out_hw=(48, 80)),
                                      pair[0].decode_batch([5, 300], out_hw=(48, 80)))
    finally:
        dec.close()


def test_no_library_raises_with_both_errors(monkeypatch, tmp_path, video):
    """The library neither loads nor builds: ``RuntimeError`` naming both
    failures, at every open, and no other decoder takes over."""
    _fresh_library(monkeypatch, tmp_path, tmp_path / "absent" / "libtstar_video.so")
    monkeypatch.setattr(tdec, "SOURCE", tmp_path / "absent" / "video_decoder.cpp")
    monkeypatch.setattr(tdec, "_PKG_CONFIG", ["libtstar-no-such-package"])
    for _ in range(2):
        with pytest.raises(RuntimeError) as err:
            tdec.open_video(video)
        msg = str(err.value)
        assert "absent/libtstar_video.so" in msg and "libtstar-no-such-package" in msg


def test_opened_closes_only_what_it_opens(video):
    mem = SyntheticDecoder(30.0, hw=(24, 32))
    with tdec.opened("unused.mp4", mem) as dec:
        assert dec is mem
    assert not mem.closed                          # its owner closes it
    with tdec.opened(video) as dec:
        assert dec.meta.total_frames == 600
    assert dec._h is None                          # opened here, closed here
