"""The port's PNG reader (nefii_tpu_torch/utils/png.py) against imageio on
seeded images: gray, gray + alpha, RGB and RGBA that imageio writes (as
tests/scene_factory.py writes its masks), gray and RGB that the port's own
writer writes, and rows written with each of the five PNG filter types. The
decoded pixels must be equal, byte for byte."""

import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

from nefii_tpu_torch.datasets.scene_dataset import load_mask
from nefii_tpu_torch.utils.png import read_png, write_png

SHAPES = {"gray": (17, 23), "gray_alpha": (17, 23, 2), "rgb": (17, 23, 3), "rgba": (17, 23, 4)}


def _image(kind, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, SHAPES[kind]).astype(np.uint8)
    img[:5] = 200  # flat rows, where an encoder picks other filters than on noise
    return img


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_reads_what_imageio_writes(tmp_path, kind):
    img = _image(kind)
    path = str(tmp_path / f"{kind}.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(read_png(path), imageio.imread(path))
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_reads_what_the_port_writes(tmp_path, kind):
    img = _image(kind, seed=1)
    path = str(tmp_path / f"{kind}.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), imageio.imread(path))
    np.testing.assert_array_equal(read_png(path), img)


def _filter_row(ftype, cur, prev, bpp):
    """Encode one row with PNG filter `ftype` (the inverse of the reader's)."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) >> 1
    else:
        pa, pb, pc = np.abs(prev - up_left), np.abs(left - up_left), np.abs(left + prev - 2 * up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
    return ((cur - pred) & 0xFF).astype(np.uint8)


def test_reads_every_filter_type(tmp_path):
    """Rows filtered with None, Sub, Up, Average and Paeth in turn, RGBA."""
    img = _image("rgba", seed=2)
    H, W, C = img.shape
    rows, prev = [], np.zeros(W * C, np.uint8)
    for y in range(H):
        ftype = y % 5
        cur = img[y].reshape(-1)
        rows.append(bytes([ftype]) + _filter_row(ftype, cur, prev, C).tobytes())
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    path = tmp_path / "filters.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(imageio.imread(str(path)), img)
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_refuses_16_bit(tmp_path):
    path = str(tmp_path / "deep.png")
    imageio.imwrite(path, (np.arange(64, dtype=np.uint16) * 1000).reshape(8, 8))
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png(path)


def test_masks_load_without_imageio(tmp_path, monkeypatch):
    """SceneDataset's mask loader reads a PNG through the port's reader."""
    mask = np.zeros((9, 11), np.uint8)
    mask[2:7, 3:9] = 255
    path = str(tmp_path / "mask.png")
    imageio.imwrite(path, mask)
    monkeypatch.setitem(__import__("sys").modules, "imageio", None)
    monkeypatch.setitem(__import__("sys").modules, "imageio.v2", None)
    np.testing.assert_array_equal(load_mask(path), mask > 127)
