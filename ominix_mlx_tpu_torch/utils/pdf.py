"""PDF ingestion for the OCR pipeline (copied from
ominix_mlx_tpu/utils/pdf.py, numpy and PIL only; importing that module
would load jax through the JAX package's ``__init__``).

Counterpart of reference deepseek-ocr2-mlx/src/pdf.rs (1-259): render PDF
pages to RGB images for the vision encoder. Backends, in order:

  1. pypdfium2 / PyMuPDF when installed (full rasterization, like the
     reference's pdfium-render backend)
  2. pure-python fallback: extract embedded page images (DCTDecode /
     FlateDecode image XObjects) — covers scanned-document PDFs, the
     dominant OCR case, with zero native dependencies
"""

from __future__ import annotations

import io
import re
import zlib
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class RenderedPage:
    image: np.ndarray       # [H, W, 3] uint8
    width: int
    height: int


def is_pdf(data: bytes) -> bool:
    return data[:5] == b"%PDF-"


def render_pdf_pages(pdf_bytes: bytes, dpi: int = 200) -> List[RenderedPage]:
    """Render/extract all pages as RGB images (reference pdf.rs:15-22)."""
    try:
        import pypdfium2 as pdfium

        doc = pdfium.PdfDocument(pdf_bytes)
        out = []
        for page in doc:
            bmp = page.render(scale=dpi / 72.0)
            arr = bmp.to_numpy()[..., :3]
            out.append(RenderedPage(arr, arr.shape[1], arr.shape[0]))
        return out
    except ImportError:
        pass
    try:
        import fitz  # PyMuPDF

        doc = fitz.open(stream=pdf_bytes, filetype="pdf")
        out = []
        for page in doc:
            pix = page.get_pixmap(dpi=dpi)
            arr = np.frombuffer(pix.samples, np.uint8).reshape(
                pix.height, pix.width, pix.n)[..., :3]
            out.append(RenderedPage(arr, pix.width, pix.height))
        return out
    except ImportError:
        pass
    return extract_embedded_images(pdf_bytes)


_STREAM_RE = re.compile(
    rb"<<(.*?)>>\s*stream\r?\n(.*?)\r?\nendstream", re.S)
_NUM_RE = {
    "w": re.compile(rb"/Width\s+(\d+)"),
    "h": re.compile(rb"/Height\s+(\d+)"),
    "bpc": re.compile(rb"/BitsPerComponent\s+(\d+)"),
}


def extract_embedded_images(pdf_bytes: bytes) -> List[RenderedPage]:
    """Pure-python path: pull /Subtype /Image XObjects out of the file.
    DCTDecode streams are JPEG (decoded via PIL); FlateDecode streams are
    raw samples. Non-image content streams are skipped."""
    out = []
    for m in _STREAM_RE.finditer(pdf_bytes):
        head, body = m.group(1), m.group(2)
        if b"/Subtype" not in head or b"/Image" not in head:
            continue
        wm, hm = _NUM_RE["w"].search(head), _NUM_RE["h"].search(head)
        if not (wm and hm):
            continue
        w, h = int(wm.group(1)), int(hm.group(1))
        try:
            if b"DCTDecode" in head or b"JPXDecode" in head:
                from PIL import Image
                img = Image.open(io.BytesIO(body)).convert("RGB")
                arr = np.asarray(img)
            elif b"FlateDecode" in head:
                raw = zlib.decompress(body)
                bpc = int(_NUM_RE["bpc"].search(head).group(1)) \
                    if _NUM_RE["bpc"].search(head) else 8
                if bpc != 8:
                    continue
                ch = len(raw) // (w * h)
                if ch not in (1, 3):
                    continue
                arr = np.frombuffer(raw[:w * h * ch], np.uint8).reshape(
                    h, w, ch)
                if ch == 1:
                    arr = np.repeat(arr, 3, axis=-1)
            else:
                continue
        except Exception:
            continue
        if arr.shape[0] >= 32 and arr.shape[1] >= 32:   # skip tiny glyphs
            out.append(RenderedPage(arr, arr.shape[1], arr.shape[0]))
    return out
