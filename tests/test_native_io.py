"""Native C++ codec (native/sdfio): cross-checked against PIL on random
images for every supported format, including the stb luminance conversion."""

import io

import numpy as np
import pytest
from PIL import Image

from chaq_sdfgen.utils import sdfio_native
from chaq_sdfgen.utils.imageio import decode_gray_alpha

pytestmark = pytest.mark.skipif(
    not sdfio_native.available(), reason="native codec not built"
)


def _pil_bytes(arr, mode, fmt):
    im = Image.fromarray(arr, mode)
    buf = io.BytesIO()
    im.save(buf, format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decode_matches_reference_semantics(mode):
    rng = np.random.default_rng(hash(mode) % 2**31)
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = (rng.random((13, 17, ch)) * 255).astype(np.uint8).squeeze()
    data = _pil_bytes(arr, mode, "PNG")
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None, "native decoder refused valid PNG"
    if mode == "L":
        np.testing.assert_array_equal(got[..., 0], arr)
        assert (got[..., 1] == 255).all()
    elif mode == "LA":
        np.testing.assert_array_equal(got, arr)
    else:
        r, g, b = (arr[..., i].astype(int) for i in range(3))
        want = ((r * 77 + g * 150 + 29 * b) >> 8).astype(np.uint8)
        np.testing.assert_array_equal(got[..., 0], want)
        if mode == "RGBA":
            np.testing.assert_array_equal(got[..., 1], arr[..., 3])


def test_png_roundtrip_native():
    rng = np.random.default_rng(0)
    img = (rng.random((31, 45)) * 255).astype(np.uint8)
    data = sdfio_native.encode_gray(img, "png")
    assert data is not None
    # our own decoder
    back = sdfio_native.decode_gray_alpha(data)
    np.testing.assert_array_equal(back[..., 0], img)
    # and PIL agrees
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil, img)


@pytest.mark.parametrize("fmt", ["bmp", "tga"])
def test_bmp_tga_roundtrip(fmt):
    rng = np.random.default_rng(1)
    img = (rng.random((22, 37)) * 255).astype(np.uint8)
    data = sdfio_native.encode_gray(img, fmt)
    assert data is not None
    back = sdfio_native.decode_gray_alpha(data)
    np.testing.assert_array_equal(back[..., 0], img)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(pil, img)


def test_bmp_decode_pil_written():
    rng = np.random.default_rng(2)
    arr = (rng.random((9, 14, 3)) * 255).astype(np.uint8)
    data = _pil_bytes(arr, "RGB", "BMP")
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None
    r, g, b = (arr[..., i].astype(int) for i in range(3))
    want = ((r * 77 + g * 150 + 29 * b) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)


def test_sample_input_native_equals_pil(sample):
    with open(sample.input, "rb") as f:
        data = f.read()
    native = sdfio_native.decode_gray_alpha(data)
    full = decode_gray_alpha(data)  # same path used by the pipeline
    if native is not None:
        np.testing.assert_array_equal(native, full)


def test_unsupported_falls_back():
    assert sdfio_native.decode_gray_alpha(b"\xff\xd8\xff\xe0 jpeg-ish") is None


def test_jpeg_encode_native_quality():
    """Baseline JPEG with the -q quality knob (openmp/sdfgen.c:327-333):
    PIL-decodable, monotone size in quality, high PSNR at q>=95."""
    x = np.linspace(0, 255, 96)
    img = (np.add.outer(x, x) / 2).astype(np.uint8)
    img[20:40, 20:60] = 255
    sizes = {}
    for q in (10, 50, 95):
        data = sdfio_native.encode_gray(img, "jpg", q)
        assert data is not None
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        dec = np.asarray(Image.open(io.BytesIO(data)).convert("L"), dtype=np.float64)
        assert dec.shape == img.shape
        mse = ((dec - img) ** 2).mean()
        psnr = 10 * np.log10(255**2 / max(mse, 1e-9))
        sizes[q] = len(data)
        if q >= 95:
            assert psnr > 40, psnr
        else:
            assert psnr > 25, psnr
    assert sizes[10] < sizes[50] < sizes[95], sizes


def test_jpeg_encode_odd_sizes():
    # non-multiple-of-8 dims exercise the edge-replication padding
    rng = np.random.default_rng(3)
    for shape in ((1, 1), (7, 9), (17, 23)):
        img = (rng.random(shape) * 255).astype(np.uint8)
        data = sdfio_native.encode_gray(img, "jpg", 90)
        assert data is not None
        dec = Image.open(io.BytesIO(data))
        assert dec.size == (shape[1], shape[0])


def test_jpeg_end_to_end_write_gray():
    """write_gray with -f jpg goes through the native encoder and the
    result decodes to roughly the source (end to end)."""
    import tempfile, os
    from chaq_sdfgen.utils.imageio import write_gray

    x = np.linspace(0, 255, 64)
    img = (np.add.outer(x, x) / 2).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        sizes = []
        for q in (20, 95):
            p = os.path.join(d, f"o{q}.jpg")
            write_gray(img, p, quality=q)
            dec = np.asarray(Image.open(p).convert("L"), dtype=np.float64)
            assert 10 * np.log10(255**2 / max(((dec - img) ** 2).mean(), 1e-9)) > 25
            sizes.append(os.path.getsize(p))
        assert sizes[0] < sizes[1]


def test_pnm_decode_native():
    # P5 raw + P2 ascii (with comment) + P6 RGB luminance
    pgm5 = b"P5\n# c\n4 3\n255\n" + bytes(range(12))
    out = sdfio_native.decode_gray_alpha(pgm5)
    assert out is not None and out.shape == (3, 4, 2)
    np.testing.assert_array_equal(out[..., 0].ravel(), np.arange(12, dtype=np.uint8))
    assert (out[..., 1] == 255).all()
    pgm2 = b"P2\n4 3\n255\n" + b" ".join(str(i).encode() for i in range(12))
    np.testing.assert_array_equal(sdfio_native.decode_gray_alpha(pgm2), out)
    ppm = b"P6\n2 1\n255\n" + bytes([255, 0, 0, 0, 255, 0])
    out3 = sdfio_native.decode_gray_alpha(ppm)
    want = np.array([(255 * 77) >> 8, (255 * 150) >> 8], dtype=np.uint8)
    np.testing.assert_array_equal(out3[0, :, 0], want)


def test_gif_and_pnm_inputs_end_to_end():
    """stb_image reads GIF/PNM (openmp/sdfgen.c:252-256 inherits it);
    both now decode natively (sdfio_decode_gif / _pnm)."""
    from chaq_sdfgen.utils.imageio import decode_gray_alpha as dec

    rng = np.random.default_rng(4)
    arr = (rng.random((11, 13)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "L").save(buf, format="GIF")
    out = dec(buf.getvalue())
    assert out.shape == (11, 13, 2)  # GIF palette-quantizes losslessly for gray
    np.testing.assert_array_equal(out[..., 0], arr)
    buf2 = io.BytesIO()
    Image.fromarray(arr, "L").save(buf2, format="PPM")
    out2 = dec(buf2.getvalue())
    np.testing.assert_array_equal(out2[..., 0], arr)


def _smooth_img(rng, h, w, ch=None):
    """Low-frequency random image (mild JPEG artifacts)."""
    shape = (h // 8 + 2, w // 8 + 2) if ch is None else (h // 8 + 2, w // 8 + 2, ch)
    small = (rng.random(shape) * 255).astype(np.uint8)
    im = Image.fromarray(small, "L" if ch is None else "RGB")
    return np.asarray(im.resize((w, h), Image.BILINEAR), np.uint8)


def _pil_gray(data):
    im = Image.open(io.BytesIO(data))
    if im.mode == "L":
        return np.asarray(im, np.uint8)
    arr = np.asarray(im.convert("RGB"), np.uint16)
    return ((arr[..., 0] * 77 + arr[..., 1] * 150 + 29 * arr[..., 2]) >> 8).astype(np.uint8)


def test_jpeg_decode_grayscale_matches_pil():
    """Native baseline JPEG decode (sdfio.cpp sdfio_decode_jpg) vs PIL:
    same Huffman/dequant stream, IDCT differs by rounding only (the
    reference's stb decoder likewise differs from libjpeg by ±1)."""
    rng = np.random.default_rng(41)
    img = _smooth_img(rng, 120, 130)
    data = _pil_bytes(img, "L", "JPEG")
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None and got.shape == (120, 130, 2)
    assert (got[..., 1] == 255).all()
    d = np.abs(got[..., 0].astype(int) - _pil_gray(data).astype(int))
    assert d.max() <= 1, d.max()


def test_jpeg_decode_color_420_matches_pil():
    rng = np.random.default_rng(42)
    img = _smooth_img(rng, 64, 70, ch=3)
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, format="JPEG", quality=85)  # 4:2:0
    data = buf.getvalue()
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None and got.shape == (64, 70, 2)
    d = np.abs(got[..., 0].astype(int) - _pil_gray(data).astype(int))
    # chroma upsample phase + fixed-vs-float YCbCr: a few levels at edges
    assert d.max() <= 3, d.max()
    assert d.mean() < 0.5, d.mean()


def test_jpeg_decode_restart_markers():
    rng = np.random.default_rng(43)
    img = _smooth_img(rng, 48, 56)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="JPEG", quality=90, restart_marker_blocks=3)
    data = buf.getvalue()
    assert b"\xff\xdd" in data  # DRI present
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None
    d = np.abs(got[..., 0].astype(int) - _pil_gray(data).astype(int))
    assert d.max() <= 1, d.max()


def test_jpeg_decode_own_encoder_roundtrip():
    """Our encoder's stream decoded by our decoder equals PIL's decode of
    the same bytes (same entropy data; IDCT rounding only)."""
    rng = np.random.default_rng(44)
    img = _smooth_img(rng, 40, 52)
    data = sdfio_native.encode_gray(img, "jpg", 95)
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None
    d = np.abs(got[..., 0].astype(int) - _pil_gray(data).astype(int))
    assert d.max() <= 1, d.max()


def test_jpeg_progressive_falls_back_to_pil():
    rng = np.random.default_rng(45)
    img = _smooth_img(rng, 32, 32)
    buf = io.BytesIO()
    Image.fromarray(img, "L").save(buf, format="JPEG", quality=90, progressive=True)
    data = buf.getvalue()
    assert sdfio_native.decode_gray_alpha(data) is None  # native refuses
    out = decode_gray_alpha(data)  # imageio falls back to PIL
    np.testing.assert_array_equal(out[..., 0], _pil_gray(data))


def test_jpeg_decode_end_to_end_imageio():
    """decode_gray_alpha takes the native path for baseline JPEG input."""
    rng = np.random.default_rng(46)
    img = _smooth_img(rng, 24, 40)
    data = _pil_bytes(img, "L", "JPEG")
    out = decode_gray_alpha(data)
    assert out.shape == (24, 40, 2)
    d = np.abs(out[..., 0].astype(int) - _pil_gray(data).astype(int))
    assert d.max() <= 1


def _psd_bytes(arr, mode, compression=0, alpha=None):
    """Hand-rolled PSD writer (composite image only) for decoder tests."""
    import struct

    h, w = arr.shape[:2]
    if mode == 1:  # grayscale
        planes = [arr] if alpha is None else [arr, alpha]
    else:  # RGB
        planes = [arr[..., 0], arr[..., 1], arr[..., 2]]
        if alpha is not None:
            planes.append(alpha)
    ch = len(planes)
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, ch, h, w, 8, mode)
    out += struct.pack(">I", 0) * 3  # color mode data, resources, layers
    if compression == 0:
        out += struct.pack(">H", 0)
        for p in planes:
            out += p.tobytes()
    else:  # PackBits: emit every row as one literal run per <=128 chunk
        out += struct.pack(">H", 1)
        rows, table = [], b""
        for p in planes:
            for y in range(h):
                row = p[y].tobytes()
                packed = b""
                for i in range(0, len(row), 128):
                    chunk = row[i : i + 128]
                    packed += bytes([len(chunk) - 1]) + chunk
                rows.append(packed)
                table += struct.pack(">H", len(packed))
        out += table + b"".join(rows)
    return out


@pytest.mark.parametrize("compression", [0, 1])
def test_psd_decode_gray_and_rgb(compression):
    rng = np.random.default_rng(51)
    g = (rng.random((21, 33)) * 255).astype(np.uint8)
    a = (rng.random((21, 33)) * 255).astype(np.uint8)
    got = sdfio_native.decode_gray_alpha(_psd_bytes(g, 1, compression, alpha=a))
    assert got is not None
    np.testing.assert_array_equal(got[..., 0], g)
    np.testing.assert_array_equal(got[..., 1], a)

    c = (rng.random((14, 19, 3)) * 255).astype(np.uint8)
    got = sdfio_native.decode_gray_alpha(_psd_bytes(c, 3, compression))
    assert got is not None
    r, gg, b = (c[..., i].astype(int) for i in range(3))
    want = ((r * 77 + gg * 150 + 29 * b) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)
    assert (got[..., 1] == 255).all()


def test_psd_decode_matches_pil():
    """Cross-check the RLE path against PIL's PSD reader on the same bytes."""
    rng = np.random.default_rng(52)
    c = np.repeat((rng.random((9, 150, 3)) * 255).astype(np.uint8), 2, axis=1)[:, :299]
    data = _psd_bytes(c, 3, compression=1)
    got = sdfio_native.decode_gray_alpha(data)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint16)
    want = ((pil[..., 0] * 77 + pil[..., 1] * 150 + 29 * pil[..., 2]) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)


def _hdr_bytes(rgbe):
    h, w = rgbe.shape[:2]
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return head + rgbe.tobytes()


def test_hdr_decode_flat():
    """Flat RGBE scanlines; LDR conversion = stb's pow(f, 1/2.2)*255+0.5."""
    rng = np.random.default_rng(53)
    h, w = 6, 7  # w < 8: flat encoding territory
    rgbe = (rng.random((h, w, 4)) * 255).astype(np.uint8)
    rgbe[..., 3] = rng.integers(118, 138, (h, w))  # sane exponents
    got = sdfio_native.decode_gray_alpha(_hdr_bytes(rgbe))
    assert got is not None and got.shape == (h, w, 2)
    f = rgbe[..., :3].astype(np.float64) * np.ldexp(
        1.0, rgbe[..., 3].astype(int) - 136
    )[..., None]
    ldr = np.clip(np.power(f, 1 / 2.2) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    want = (
        (ldr[..., 0].astype(int) * 77 + ldr[..., 1].astype(int) * 150 + 29 * ldr[..., 2].astype(int)) >> 8
    ).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)


def test_hdr_decode_new_rle():
    """New-style (2,2) RLE scanlines with runs and literals."""
    rng = np.random.default_rng(54)
    h, w = 4, 64
    rgbe = (rng.random((h, w, 4)) * 255).astype(np.uint8)
    rgbe[..., 3] = 128
    rgbe[1, :, 0] = 37  # a full-row run in the red component
    payload = b""
    for y in range(h):
        payload += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            comp = rgbe[y, :, c].tobytes()
            x = 0
            while x < w:
                # alternate a short run and literals to hit both branches
                if x + 4 <= w and comp[x] == comp[x + 1] == comp[x + 2] == comp[x + 3]:
                    run = 4
                    while x + run < w and comp[x + run] == comp[x] and run < 127:
                        run += 1
                    payload += bytes([128 + run, comp[x]])
                    x += run
                else:
                    n = min(16, w - x)
                    payload += bytes([n]) + comp[x : x + n]
                    x += n
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    got = sdfio_native.decode_gray_alpha(head + payload)
    assert got is not None and got.shape == (h, w, 2)
    flat = sdfio_native.decode_gray_alpha(_hdr_bytes(rgbe[:, :7]))  # sanity only
    f = rgbe[..., :3].astype(np.float64) * np.ldexp(
        1.0, rgbe[..., 3].astype(int) - 136
    )[..., None]
    ldr = np.clip(np.power(f, 1 / 2.2) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    want = (
        (ldr[..., 0].astype(int) * 77 + ldr[..., 1].astype(int) * 150 + 29 * ldr[..., 2].astype(int)) >> 8
    ).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)


def _pic_bytes(rgb, alpha=None, ptype=2):
    """Hand-built Softimage PIC: one RGB packet (+ optional chained alpha
    packet), packet type 0 (raw), 1 (pure RLE) or 2 (mixed RLE)."""
    h, w = rgb.shape[:2]
    head = bytes([0x53, 0x80, 0xF6, 0x34]) + b"\x00" * 4 + b"\x00" * 80 + b"PICT"
    head += w.to_bytes(2, "big") + h.to_bytes(2, "big")
    head += b"\x00" * 4 + (3).to_bytes(2, "big") + b"\x00\x00"
    chained = 1 if alpha is not None else 0
    pkts = bytes([chained, 8, ptype, 0x80 | 0x40 | 0x20])
    if alpha is not None:
        pkts += bytes([0, 8, ptype, 0x10])

    def encode_row(px_rows):  # px_rows: (w, nch) uint8
        wl = px_rows.shape[0]
        if ptype == 0:
            return px_rows.tobytes()
        out = b""
        x = 0
        while x < wl:
            run = 1
            while x + run < wl and run < 120 and (px_rows[x + run] == px_rows[x]).all():
                run += 1
            if ptype == 1:
                out += bytes([run]) + px_rows[x].tobytes()
            elif run >= 2:
                out += bytes([127 + run]) + px_rows[x].tobytes()
            else:
                lit = 1
                while (
                    x + lit < wl
                    and lit < 100
                    and not (
                        x + lit + 1 < wl
                        and (px_rows[x + lit] == px_rows[x + lit + 1]).all()
                    )
                ):
                    lit += 1
                out += bytes([lit - 1]) + px_rows[x : x + lit].tobytes()
                run = lit
            x += run
        return out

    body = b""
    for y in range(h):
        body += encode_row(rgb[y])
        if alpha is not None:
            body += encode_row(alpha[y][:, None])
    return head + pkts + body


@pytest.mark.parametrize("ptype", [0, 1, 2])
def test_pic_decode(ptype):
    """Softimage PIC (stb_image input format; PIL has no PIC reader, so
    the native codec is the only path). All three packet encodings."""
    rng = np.random.default_rng(54)
    rgb = np.repeat((rng.random((9, 15, 3)) * 255).astype(np.uint8), 3, axis=1)[:, :37]
    a = np.repeat((rng.random((9, 13)) * 255).astype(np.uint8), 3, axis=1)[:, :37]
    got = sdfio_native.decode_gray_alpha(_pic_bytes(rgb, alpha=a, ptype=ptype))
    assert got is not None and got.shape == (9, 37, 2)
    r, g, b = (rgb[..., i].astype(int) for i in range(3))
    want = ((r * 77 + g * 150 + 29 * b) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)
    np.testing.assert_array_equal(got[..., 1], a)
    # RGB-only: alpha defaults to 255 (stb memset-0xff semantics)
    got2 = sdfio_native.decode_gray_alpha(_pic_bytes(rgb, ptype=ptype))
    assert (got2[..., 1] == 255).all()


def test_pic_long_run_u16_count():
    """Mixed-RLE count==128 takes an explicit u16be repeat count."""
    w = 300
    rgb = np.full((2, w, 3), 77, np.uint8)
    head = bytes([0x53, 0x80, 0xF6, 0x34]) + b"\x00" * 4 + b"\x00" * 80 + b"PICT"
    head += w.to_bytes(2, "big") + (2).to_bytes(2, "big")
    head += b"\x00" * 4 + (3).to_bytes(2, "big") + b"\x00\x00"
    pkts = bytes([0, 8, 2, 0xE0])
    row = bytes([128]) + w.to_bytes(2, "big") + bytes([77, 77, 77])
    got = sdfio_native.decode_gray_alpha(head + pkts + row + row)
    assert got is not None and got.shape == (2, w, 2)
    assert (got[..., 0] == 77).all() and (got[..., 1] == 255).all()


def _stb_lum_rgb(rgb):
    a = rgb.astype(np.uint16)
    return ((a[..., 0] * 77 + a[..., 1] * 150 + 29 * a[..., 2]) >> 8).astype(np.uint8)


@pytest.mark.parametrize("interlace", [False, True])
def test_gif_decode_native(interlace):
    """Native GIF (raster, first frame, LZW): palette + interlace; stb's
    integer luminance on the palette RGB (reference inherits GIF via stb,
    openmp/sdfgen.c:252-256)."""
    from chaq_sdfgen.utils import sdfio_native

    rng = np.random.default_rng(17 + interlace)
    a = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    img = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    img.save(buf, format="GIF", interlace=interlace)
    data = buf.getvalue()
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(got[..., 0], _stb_lum_rgb(rgb))
    assert (got[..., 1] == 255).all()


def test_gif_decode_native_transparency():
    from chaq_sdfgen.utils import sdfio_native

    rng = np.random.default_rng(23)
    a = (rng.random((24, 31, 3)) * 255).astype(np.uint8)
    img = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    img.save(buf, format="GIF", transparency=3)
    data = buf.getvalue()
    got = sdfio_native.decode_gray_alpha(data)
    assert got is not None
    pidx = np.asarray(Image.open(io.BytesIO(data)))
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    tr = pidx == 3
    # transparent pixels: gray 0 / alpha 0 (stb's transparent-black
    # canvas); the rest carry palette luminance at alpha 255
    assert ((got[..., 1] == 0) == tr).all()
    assert (got[..., 0][tr] == 0).all()
    np.testing.assert_array_equal(got[..., 0][~tr], _stb_lum_rgb(rgb)[~tr])


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_decode_adam7_interlaced(mode):
    """Adam7 interlaced PNG decodes natively (the last stb O9 format
    delta) — bit-identical to the sequential decode of the same pixels. Odd dims exercise partial/empty interlace passes."""
    rng = np.random.default_rng(101 + len(mode))
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    for shape in [(37, 53), (7, 3), (1, 1), (8, 8), (9, 2)]:
        arr = (rng.random((*shape, ch)) * 255).astype(np.uint8)
        arr = arr[..., 0] if ch == 1 else arr
        im = Image.fromarray(arr, mode)
        buf = io.BytesIO()
        im.save(buf, format="PNG", interlace=True)
        got = sdfio_native.decode_gray_alpha(buf.getvalue())
        assert got is not None, f"refused interlaced {mode} {shape}"
        seq = sdfio_native.decode_gray_alpha(_pil_bytes(arr, mode, "PNG"))
        np.testing.assert_array_equal(got, seq)


def test_png_decode_16bit_gray():
    """16-bit grayscale PNG: native decode takes the high (big-endian
    first) byte per sample — stb's stbi__convert_16_to_8 rule."""
    rng = np.random.default_rng(202)
    img16 = (rng.random((25, 31)) * 65535).astype(np.uint16)
    im = Image.new("I;16", (img16.shape[1], img16.shape[0]))
    im.frombytes(img16.astype("<u2").tobytes())
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    got = sdfio_native.decode_gray_alpha(buf.getvalue())
    assert got is not None, "refused 16-bit PNG"
    np.testing.assert_array_equal(got[..., 0], (img16 >> 8).astype(np.uint8))
    assert (got[..., 1] == 255).all()


def test_png_decode_16bit_rgb_interlaced():
    """16-bit RGB + Adam7 together (both new paths compose)."""
    import struct
    import zlib

    rng = np.random.default_rng(203)
    h, w = 11, 6
    rgb16 = (rng.random((h, w, 3)) * 65535).astype(np.uint16)
    # hand-rolled interlaced 16-bit PNG (PIL won't write one)
    X0, Y0 = [0, 4, 0, 2, 0, 1, 0], [0, 0, 4, 0, 2, 0, 1]
    DX, DY = [8, 8, 4, 4, 2, 2, 1], [8, 8, 8, 4, 4, 2, 2]
    raw = bytearray()
    for p in range(7):
        pw = (w - X0[p] + DX[p] - 1) // DX[p] if w > X0[p] else 0
        ph = (h - Y0[p] + DY[p] - 1) // DY[p] if h > Y0[p] else 0
        if not pw or not ph:
            continue
        for yy in range(ph):
            raw.append(0)  # filter none
            for xx in range(pw):
                px = rgb16[Y0[p] + yy * DY[p], X0[p] + xx * DX[p]]
                for c in px:
                    raw += struct.pack(">H", int(c))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 1)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(bytes(raw)))
        + chunk(b"IEND", b"")
    )
    got = sdfio_native.decode_gray_alpha(png)
    assert got is not None, "refused interlaced 16-bit PNG"
    hi = (rgb16 >> 8).astype(np.uint16)
    want = ((hi[..., 0] * 77 + hi[..., 1] * 150 + 29 * hi[..., 2]) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got[..., 0], want)
    # PIL cross-check of the hand-rolled file (PIL loads 16-bit RGB
    # as 8-bit high bytes already)
    pil = np.asarray(Image.open(io.BytesIO(png)))
    np.testing.assert_array_equal(pil, hi.astype(np.uint8))
