"""Image I/O (reference L4): stb-parity loading and 1-channel writers.

Mirrors the reference's stb usage: load forces 2 channels gray+alpha
(openmp/sdfgen.c:246-258, opencl/main.cpp:111-199) with stb's integer
luminance ((r*77 + g*150 + 29*b) >> 8); write emits a single-channel
image in PNG/BMP/TGA/JPG with the filetype deduced from the output
extension, PNG fallback (openmp/sdfgen.c:304-347). "-" means
stdin/stdout (openmp/sdfgen.c:149-169).

Backend: a native C++ codec (native/sdfio) when built, else PIL. Both
produce identical pixel buffers for the supported formats.
"""

from __future__ import annotations

import io
import os
import sys
from typing import BinaryIO, Optional, Union

import numpy as np

# filetype tables mirror openmp/sdfgen.c:108-115 (strncmp, 3 chars) and
# opencl/main.cpp:31-74 (case-insensitive substring)
FILETYPES = ("png", "bmp", "jpg", "tga")


def read_filetype(s: str) -> Optional[str]:
    """openmp read_filetype: prefix-match on {png,bmp,jpg,tga}
    (sdfgen.c:108-115; 'jpeg' matches 'jpg' via the 3-char compare)."""
    s = s.lower()
    for ft in FILETYPES:
        if s[:3] == ft[:3]:
            return ft
    return None


def filetype_from_str_opencl(s: str) -> str:
    """opencl filetype::from_str: case-insensitive substring over
    {png, jpeg, jpg, tga, bmp}, fallback png (opencl/main.cpp:31-58)."""
    t = s.lower()
    for name, ft in (("png", "png"), ("jpeg", "jpg"), ("jpg", "jpg"), ("tga", "tga"), ("bmp", "bmp")):
        if name in t:
            return ft
    return "png"


def deduce_filetype(outfile: str, explicit: Optional[str] = None) -> str:
    """Explicit -f beats extension; extension beats the png default
    (openmp/sdfgen.c:304-310)."""
    if explicit:
        ft = read_filetype(explicit)
        if ft is None:
            raise ValueError(f"invalid filetype {explicit!r}")
        return ft
    dot = outfile.rfind(".")
    if dot >= 0:
        ft = read_filetype(outfile[dot + 1 :])
        if ft is not None:
            return ft
    return "png"


def _native_codec():
    try:
        from chaq_sdfgen.utils import sdfio_native

        return sdfio_native if sdfio_native.available() else None
    except Exception:
        return None


def load_gray_alpha(path_or_dash: Union[str, BinaryIO]) -> np.ndarray:
    """Load any supported image as (H, W, 2) uint8 gray+alpha (stb-parity).
    '-' reads the full stream from stdin."""
    if isinstance(path_or_dash, str) and path_or_dash == "-":
        data = sys.stdin.buffer.read()
        return decode_gray_alpha(data)
    if isinstance(path_or_dash, str):
        with open(path_or_dash, "rb") as f:
            return decode_gray_alpha(f.read())
    return decode_gray_alpha(path_or_dash.read())


def decode_gray_alpha(data: bytes) -> np.ndarray:
    native = _native_codec()
    if native is not None:
        out = native.decode_gray_alpha(data)
        if out is not None:
            return out
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    if im.mode in ("1", "L", "I;16", "I"):
        gray = np.asarray(im.convert("L"), dtype=np.uint8)
        alpha = np.full_like(gray, 255)
    elif im.mode == "LA":
        arr = np.asarray(im, dtype=np.uint8)
        gray, alpha = arr[..., 0], arr[..., 1]
    else:
        arr = np.asarray(im.convert("RGBA"), dtype=np.uint16)
        r, g, b, a = (arr[..., i] for i in range(4))
        gray = ((r * 77 + g * 150 + 29 * b) >> 8).astype(np.uint8)
        alpha = a.astype(np.uint8)
    return np.stack([gray, alpha], axis=-1)


def write_gray(
    img: np.ndarray,
    outfile: str,
    filetype: Optional[str] = None,
    quality: int = 100,
) -> None:
    """Write (H, W) uint8 as a 1-channel image; '-' streams to stdout
    (openmp/sdfgen.c:117-120, 313-347)."""
    ft = deduce_filetype(outfile if outfile != "-" else "", filetype)
    data = encode_gray(img, ft, quality)
    if outfile == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(outfile, "wb") as f:
            f.write(data)


def write_gray_alpha(
    img: np.ndarray,
    outfile: str,
    filetype: Optional[str] = None,
    quality: int = 100,
) -> None:
    """Write (H, W) uint8 as gray+alpha(=255), the OpenCL binary's output
    layout (opencl/main.cpp:166-199; the kernel writes (val,val,val,255),
    sdf.cl:222-223)."""
    from PIL import Image

    ft = deduce_filetype(outfile if outfile != "-" else "", filetype)
    la = np.stack([np.ascontiguousarray(img, np.uint8), np.full_like(img, 255)], -1)
    im = Image.fromarray(la, mode="LA")
    buf = io.BytesIO()
    if ft == "jpg":  # JPEG has no alpha; write gray like stb would collapse
        im.convert("L").save(buf, format="JPEG", quality=int(quality))
    elif ft in ("bmp", "tga"):
        (im.convert("LA") if ft == "tga" else im.convert("RGB")).save(
            buf, format=ft.upper()
        )
    else:
        im.save(buf, format="PNG")
    data = buf.getvalue()
    if outfile == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(outfile, "wb") as f:
            f.write(data)


def encode_gray(img: np.ndarray, filetype: str, quality: int = 100) -> bytes:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    native = _native_codec()
    if native is not None:
        out = native.encode_gray(img, filetype, quality)
        if out is not None:
            return out
    from PIL import Image

    im = Image.fromarray(img, mode="L")
    buf = io.BytesIO()
    if filetype == "jpg":
        im.save(buf, format="JPEG", quality=int(quality))
    elif filetype == "bmp":
        im.save(buf, format="BMP")
    elif filetype == "tga":
        im.save(buf, format="TGA")
    else:
        im.save(buf, format="PNG")
    return buf.getvalue()
