"""The port's EXR reader (nefii_tpu_torch/utils/exr.py) on scanline files
whose chunk-offset table still holds an unwritten (zero) entry, as an
interrupted writer leaves it: the reader raises instead of decoding a chunk
from offset 0, in a multi-part file (whose chunks lead with a part number)
and in a single-part file the port writes itself. The intact files read."""

import os
import struct

import numpy as np
import pytest

from nefii_tpu_torch.utils import exr

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "exr")


def _multipart(tmp_path, zero):
    """tests/fixtures/exr/multipart.exr with entry `zero` of part 0's offset
    table (a ZIP scanline part, 41 lines: 3 blocks of 16) set to 0."""
    data = bytearray(open(os.path.join(FIX, "multipart.exr"), "rb").read())
    headers, off, multipart = exr._parse_headers(bytes(data))
    assert multipart and struct.unpack("<i", headers[0]["chunkCount"][1])[0] == 3
    if zero is not None:
        data[off + 8 * zero: off + 8 * zero + 8] = b"\0" * 8
    path = tmp_path / "multipart.exr"
    path.write_bytes(bytes(data))
    return str(path)


def _single_part(tmp_path, zero):
    """A 40-line ZIP scanline file from the port's writer (3 blocks of 16)
    with entry `zero` of its line-offset table set to 0."""
    img = np.random.RandomState(0).rand(40, 7, 3).astype(np.float32)
    path = str(tmp_path / "single.exr")
    exr.write(path, img, compression=exr.ZIP)
    data = bytearray(open(path, "rb").read())
    _, off, multipart = exr._parse_headers(bytes(data))
    assert not multipart
    if zero is not None:
        data[off + 8 * zero: off + 8 * zero + 8] = b"\0" * 8
        with open(path, "wb") as f:
            f.write(bytes(data))
    return path, img


@pytest.mark.parametrize("zero", [0, 1, 2])
def test_multipart_scanline_with_a_zero_offset_raises(tmp_path, zero):
    with pytest.raises(ValueError, match="incomplete scanline EXR: 1 of 3 blocks missing"):
        exr.read(_multipart(tmp_path, zero), part=0)


@pytest.mark.parametrize("zero", [0, 2])
def test_single_part_scanline_with_a_zero_offset_raises(tmp_path, zero):
    path, _ = _single_part(tmp_path, zero)
    with pytest.raises(ValueError, match="incomplete scanline EXR: 1 of 3 blocks missing"):
        exr.read(path)


def test_intact_scanline_files_read(tmp_path):
    gt = np.fromfile(os.path.join(FIX, "multipart_part0.f32"), np.float32).reshape(41, 73, 3)
    np.testing.assert_array_equal(exr.read(_multipart(tmp_path, None), part=0), gt)
    path, img = _single_part(tmp_path, None)
    np.testing.assert_array_equal(exr.read(path), img)
