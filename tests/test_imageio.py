"""Image IO: the numpy + zlib grayscale PNG codec and the Pillow gate."""

import sys

import numpy as np
import pytest

from warmup_fir_filter_tpu.utils.imageio import (
    iter_image_files,
    load_gray_u8,
    save_gray_png,
)


@pytest.mark.parametrize("shape", [(1, 1), (4, 8), (37, 53), (300, 17),
                                   (853, 1280)])
def test_png_round_trip(rng, tmp_path, shape):
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "sub" / "img.png"
    save_gray_png(path, img)
    np.testing.assert_array_equal(load_gray_u8(path), img)


def test_save_rejects_non_u8_or_non_2d(tmp_path):
    with pytest.raises(ValueError, match="2D uint8"):
        save_gray_png(tmp_path / "a.png", np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="2D uint8"):
        save_gray_png(tmp_path / "b.png", np.zeros((2, 2, 3), np.uint8))


@pytest.mark.parametrize("kind", ["noise", "ramp", "rows"])
def test_reads_pillow_png_with_every_row_filter(rng, tmp_path, kind):
    """Pillow's encoder picks Sub/Up/Average/Paeth row filters per row;
    the codec must undo each."""
    Image = pytest.importorskip("PIL.Image")
    r = np.arange(60)[:, None]
    c = np.arange(77)[None, :]
    img = {
        "noise": rng.integers(0, 256, size=(60, 77)),
        "ramp": (r * 3 + c * 2) % 256,
        "rows": np.clip(r * 4 + rng.integers(0, 3, (60, 77)), 0, 255),
    }[kind].astype(np.uint8)
    Image.fromarray(img, mode="L").save(tmp_path / "p.png", optimize=True)
    np.testing.assert_array_equal(load_gray_u8(tmp_path / "p.png"), img)


def test_pillow_reads_codec_png(rng, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = rng.integers(0, 256, size=(31, 45), dtype=np.uint8)
    save_gray_png(tmp_path / "o.png", img)
    with Image.open(tmp_path / "o.png") as pil:
        assert pil.mode == "L"
        np.testing.assert_array_equal(np.asarray(pil), img)


def test_jpeg_without_pillow_fails_loudly(tmp_path, monkeypatch):
    path = tmp_path / "x.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        load_gray_u8(path)


def test_png_without_pillow_needs_nothing(rng, tmp_path, monkeypatch):
    img = rng.integers(0, 256, size=(9, 11), dtype=np.uint8)
    save_gray_png(tmp_path / "g.png", img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(load_gray_u8(tmp_path / "g.png"), img)


def test_rgb_png_goes_through_pillow(rng, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rgb = rng.integers(0, 256, size=(5, 6, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(tmp_path / "c.png")
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(load_gray_u8(tmp_path / "c.png"), want)


def test_not_a_png_rejected(tmp_path):
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        load_gray_u8(tmp_path / "bad.png")


def test_iter_image_files_sorted_case_insensitive(tmp_path):
    for name in ("b.PNG", "a.jpg", "C.bmp", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert [p.name for p in iter_image_files(tmp_path)] == [
        "a.jpg", "b.PNG", "C.bmp"]
