"""Port: the baseline JPEG codec (``native/jpeg.cpp`` through
``aicamera_tpu_torch/utils/jpeg.py``) against OpenCV's libjpeg-turbo.

Decode: bitwise ``cv2.imdecode(..., IMREAD_COLOR)`` over quality x sampling
x size x restart interval, gray files, every EXIF orientation. Encode: the
port's bytes equal ``cv2.imencode``'s, so their decodes are equal too.
Refusals: progressive, arithmetic, lossless, hierarchical, 12-bit and
CMYK files raise ``ValueError`` naming the kind. The C++ builds with the
host's ``c++`` into ``aicamera_tpu_torch/_build/`` (a missing compiler
fails the tests). Tolerance everywhere: bitwise.
"""

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from aicamera_tpu_torch.utils import jpeg  # noqa: E402

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111}
SIZES = [(8, 8), (37, 61), (61, 37), (3, 5), (17, 33), (541, 959)]


def _image(hw, seed):
    """Gradients with noise: every coefficient band carries energy."""
    rng = np.random.RandomState(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 5) % 256, ((x + y) * 2) % 256],
                    -1).astype(np.float32)
    return np.clip(base + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _cv2_bytes(img, quality=95, sampling="420", restart=0, **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    for k, v in extra.items():
        params += [getattr(cv2, k), v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _imdecode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("sampling", [*SAMPLING, "gray"])
def test_decode_matches_imdecode(sampling, hw):
    """Quality 50, 75, 95, restart interval off and on (every 3 MCUs)."""
    img = _image(hw, 10 * SIZES.index(hw) + len(sampling))
    if sampling == "gray":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    for quality in (50, 75, 95):
        for restart in (0, 3):
            data = _cv2_bytes(img, quality, sampling, restart)
            got = jpeg.decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == (*hw, 3)
            np.testing.assert_array_equal(got, _imdecode(data),
                                          err_msg=f"q{quality} rst{restart}")


def _exif(orientation, little_endian):
    e = "<" if little_endian else ">"
    tiff = ((b"II*\x00" if little_endian else b"MM\x00*")
            + struct.pack(e + "I", 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHI", 0x0112, 3, 1)
            + struct.pack(e + "H", orientation) + b"\x00\x00"
            + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(2, 9))
def test_exif_orientation_as_imdecode(orientation):
    """A camera JPEG with an orientation tag comes out rotated/flipped as
    ``IMREAD_COLOR`` turns it (both TIFF byte orders)."""
    data = _cv2_bytes(_image((21, 34), orientation))
    for le in (True, False):
        tagged = data[:2] + _exif(orientation, le) + data[2:]
        want = _imdecode(tagged)
        got = jpeg.decode_jpeg(tagged)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert jpeg.decode_jpeg(tagged, apply_orientation=False).shape == \
        (21, 34, 3)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("hw", [(37, 61), (540, 960), (1, 1)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_encode_matches_imencode(quality, hw):
    """The port's bytes are ``cv2.imencode``'s (4:2:0, its default; a gray
    frame as one component), so ``imdecode`` of both is equal."""
    img = _image(hw, quality)
    ours = jpeg.encode_jpeg(img, quality)
    want = _cv2_bytes(img, quality)
    assert ours == want
    np.testing.assert_array_equal(_imdecode(ours), _imdecode(want))
    np.testing.assert_array_equal(jpeg.decode_jpeg(ours), _imdecode(want))
    gray = img[..., 1].copy()
    assert jpeg.encode_jpeg(gray, quality) == _cv2_bytes(gray, quality)


def test_encode_default_is_q95_420():
    img = _image((48, 64), 5)
    ok, buf = cv2.imencode(".jpg", img)
    assert jpeg.encode_jpeg(img) == buf.tobytes()


def _with_sof(data, marker):
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    b[i + 1] = marker
    return bytes(b)


@pytest.mark.parametrize("kind,make", [
    ("progressive", lambda d, img: _cv2_bytes(
        img, IMWRITE_JPEG_PROGRESSIVE=1)),
    ("arithmetic", lambda d, img: _with_sof(d, 0xC9)),
    ("lossless", lambda d, img: _with_sof(d, 0xC3)),
    ("hierarchical", lambda d, img: _with_sof(d, 0xC5)),
    ("12-bit", lambda d, img: d.replace(b"\xff\xc0\x00\x11\x08",
                                        b"\xff\xc1\x00\x11\x0c", 1)),
    ("CMYK", lambda d, img: _cmyk(d)),
])
def test_refusals_name_the_kind(kind, make):
    img = _image((16, 24), 0)
    data = make(_cv2_bytes(img), img)
    with pytest.raises(ValueError, match=kind):
        jpeg.decode_jpeg(data)


def _cmyk(data):
    """A SOF0 of four components (the rest of the file unchanged)."""
    i = data.index(b"\xff\xc0")
    length = struct.unpack(">H", data[i + 2:i + 4])[0]
    sof = bytearray(data[i + 4:i + 2 + length])
    sof[5] = 4
    sof += bytes([4, 0x11, 1])
    return (data[:i] + b"\xff\xc0" + struct.pack(">H", len(sof) + 2)
            + bytes(sof) + data[i + 2 + length:])


def test_decode_image_picks_by_magic(tmp_path):
    img = _image((20, 30), 1)
    jpg = _cv2_bytes(img)
    png = cv2.imencode(".png", img)[1].tobytes()
    np.testing.assert_array_equal(jpeg.decode_image(jpg), _imdecode(jpg))
    np.testing.assert_array_equal(jpeg.decode_image(png), img)
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        jpeg.decode_image(b"GIF89a....")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(jpg[:40])
    i = jpg.index(b"\xff\xc0") + 5            # height, width: 65535
    huge = jpg[:i] + b"\xff\xff\xff\xff" + jpg[i + 4:]
    with pytest.raises(ValueError, match="larger than"):
        jpeg.decode_jpeg(huge)
    p = tmp_path / "x.jpg"
    p.write_bytes(jpg)
    np.testing.assert_array_equal(jpeg.read_jpeg(p), cv2.imread(str(p)))
