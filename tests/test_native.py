"""Native C++ frame loader vs the pure-Python codec. The library is built
from native/frame_loader.cpp at first use; the comparisons skip only on a
machine without a toolchain."""

import numpy as np
import pytest

from pmv_tpu.io import native, png


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native frame loader could not be built (make -C native)")


class TestNativeLoader:
    def test_gray_matches_python(self, built, tmp_path, rng):
        img = rng.integers(0, 256, (37, 53), np.uint8)
        p = tmp_path / "g.png"
        png.write_png(p, img)
        a = native.load_grayscale(p)
        b = png.load_grayscale(p)
        np.testing.assert_allclose(a, b, atol=1e-4)

    def test_rgb_matches_python(self, built, tmp_path, rng):
        img = rng.integers(0, 256, (21, 33, 3), np.uint8)
        p = tmp_path / "c.png"
        png.write_png(p, img)
        a = native.load_grayscale(p)
        b = png.load_grayscale(p)
        np.testing.assert_allclose(a, b, atol=0.51)  # float vs float rounding

    def test_missing_file(self, built):
        with pytest.raises(ValueError):
            native.load_grayscale("/nonexistent.png")

    def test_corrupt_file(self, built, tmp_path):
        p = tmp_path / "bad.png"
        p.write_bytes(b"not a png at all")
        with pytest.raises(ValueError):
            native.load_grayscale(p)


def test_build_at_first_use(tmp_path, rng):
    """A checkout without the library builds it from frame_loader.cpp
    (``make -C native``) on first use, and the result decodes PNGs."""
    import ctypes
    import shutil

    if shutil.which("make") is None:
        pytest.skip("no make on this machine")
    for f in ("Makefile", "frame_loader.cpp"):
        shutil.copy(native.NATIVE_DIR / f, tmp_path / f)
    lib_path = tmp_path / native.LIB_PATH.name
    assert not lib_path.exists()
    assert native.build(tmp_path)
    assert lib_path.is_file()
    lib = ctypes.CDLL(str(lib_path))
    img = rng.integers(0, 256, (9, 14), np.uint8)
    png.write_png(tmp_path / "x.png", img)
    buf = np.empty(9 * 14, np.float32)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.fl_decode_gray(
        str(tmp_path / "x.png").encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.size,
        ctypes.byref(h), ctypes.byref(w),
    )
    assert rc == 0 and (h.value, w.value) == (9, 14)
    np.testing.assert_allclose(buf.reshape(9, 14), img, atol=1e-4)
