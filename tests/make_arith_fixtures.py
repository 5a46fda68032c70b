"""Writes ``tests/golden/jpeg_arith/``: arithmetic-coded JPEGs (SOF9 and
SOF10) written by libjpeg's own compressor (``jcarith.c``), and what the
JAX package's decoders make of them, so the port's arithmetic decoder is
held against files it did not write, on any machine (the card's has
neither cv2 nor libjpeg's headers).

  *.jpg            the files; ``MANIFEST.json`` names libjpeg's version and
                   each file's parameters (size, colour, sampling, quality,
                   progression, restart interval, conditioning, EXIF
                   orientation)
  reference.npz    per file ``<name>/native64`` and ``<name>/native64_pre``:
                   JAX's ``native_decode_resize_mem`` at 64 px with
                   ``prescale_min`` 0 and 128 (None -> absent; the second
                   only where it differs from the first), and, for
                   the files of fewer than 64 x 64 pixels, ``<name>/cv2``:
                   ``cv2.imdecode``'s full-scale pixels in RGB order

The pixels come from a seeded numpy photo; a small C program, compiled
here against the system libjpeg (``cc ... -ljpeg``; it needs libjpeg's
headers, built with ``C_ARITH_CODING_SUPPORTED``), writes each file.
Run from the repository root (it rewrites the directory):

    JAX_PLATFORMS=cpu python tests/make_arith_fixtures.py
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "golden" / "jpeg_arith"
sys.path.insert(0, str(ROOT))

# argv: raw out width height colour quality h v progressive restart_interval
# restart_in_rows orientation [L U K per table 0, then table 1]
WRITER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc < 13) return 2;
  int w = atoi(argv[3]), h = atoi(argv[4]);
  const char *colour = argv[5];
  int ncomp = !strcmp(colour, "gray") ? 1
              : (!strcmp(colour, "cmyk") || !strcmp(colour, "ycck")) ? 4 : 3;
  size_t size = (size_t)w * h * ncomp;
  unsigned char *pix = malloc(size);
  FILE *in = fopen(argv[1], "rb");
  if (!in || fread(pix, 1, size, in) != size) return 3;
  fclose(in);
  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE
                         : ncomp == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  if (!strcmp(colour, "ycck")) jpeg_set_colorspace(&cinfo, JCS_YCCK);
  jpeg_set_quality(&cinfo, atoi(argv[6]), TRUE);
  cinfo.comp_info[0].h_samp_factor = atoi(argv[7]);
  cinfo.comp_info[0].v_samp_factor = atoi(argv[8]);
  if (ncomp == 4) {
    cinfo.comp_info[3].h_samp_factor = atoi(argv[7]);
    cinfo.comp_info[3].v_samp_factor = atoi(argv[8]);
  }
  cinfo.arith_code = TRUE;
  if (atoi(argv[9])) jpeg_simple_progression(&cinfo);
  cinfo.restart_interval = atoi(argv[10]);
  cinfo.restart_in_rows = atoi(argv[11]);
  for (int t = 0; t < 2 && 15 + 3 * t < argc; ++t) {
    cinfo.arith_dc_L[t] = atoi(argv[13 + 3 * t]);
    cinfo.arith_dc_U[t] = atoi(argv[14 + 3 * t]);
    cinfo.arith_ac_K[t] = atoi(argv[15 + 3 * t]);
  }
  jpeg_start_compress(&cinfo, TRUE);
  int orient = atoi(argv[12]);
  if (orient) {
    /* a big-endian TIFF with one IFD entry: Orientation (0x0112) */
    unsigned char exif[] = {'E', 'x', 'i', 'f', 0, 0, 'M', 'M', 0, 42, 0, 0,
                            0, 8, 0, 1, 0x01, 0x12, 0, 3, 0, 0, 0, 1, 0,
                            (unsigned char)orient, 0, 0, 0, 0, 0, 0};
    jpeg_write_marker(&cinfo, JPEG_APP0 + 1, exif, sizeof(exif));
  }
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pix + (size_t)cinfo.next_scanline * w * ncomp;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  fclose(out);
  return 0;
}
"""

# (name, size HxW, colour, sampling (h, v), progressive, restart interval,
#  restart in rows, conditioning (L, U, K) of tables 0 and 1, orientation)
FILES = [
    *[(f"sof9_{s}_33x41", (33, 41), "ycc", hv, False, 0, 0, None, 0)
      for s, hv in (("420", (2, 2)), ("422", (2, 1)), ("444", (1, 1)))],
    ("sof9_gray_33x41", (33, 41), "gray", (1, 1), False, 0, 0, None, 0),
    *[(f"sof9_{s}_96x64", (64, 96), "ycc", hv, False, 0, 0, None, 0)
      for s, hv in (("420", (2, 2)), ("422", (2, 1)), ("444", (1, 1)))],
    ("sof9_gray_96x64", (64, 96), "gray", (1, 1), False, 0, 0, None, 0),
    ("sof9_restart2", (64, 96), "ycc", (2, 2), False, 2, 0, None, 0),
    ("sof9_restart_rows1", (64, 96), "ycc", (2, 1), False, 0, 1, None, 0),
    ("sof9_dac", (64, 96), "ycc", (2, 2), False, 0, 0,
     ((2, 5, 10), (1, 3, 20)), 0),
    ("sof10_420_96x64", (64, 96), "ycc", (2, 2), True, 0, 0, None, 0),
    ("sof10_gray_96x64", (64, 96), "gray", (1, 1), True, 0, 0, None, 0),
    ("sof10_restart3", (64, 96), "ycc", (2, 2), True, 3, 0, None, 0),
    ("sof9_cmyk", (48, 64), "cmyk", (1, 1), False, 0, 0, None, 0),
    ("sof9_ycck", (48, 64), "ycck", (2, 2), False, 0, 0, None, 0),
    ("sof9_640x480", (480, 640), "ycc", (2, 2), False, 0, 0, None, 0),
    ("sof10_640x480", (480, 640), "ycc", (2, 2), True, 0, 0, None, 0),
    ("sof9_exif6", (40, 56), "ycc", (2, 2), False, 0, 0, None, 6),
]


def photo(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """A smooth random image, [h, w, channels] uint8."""
    import cv2

    rng = np.random.default_rng(seed)
    x = rng.normal(128, 50, (h // 12 + 2, w // 12 + 2, channels))
    x = cv2.resize(x.astype(np.float32), (w, h),
                   interpolation=cv2.INTER_CUBIC).reshape(h, w, channels)
    return np.clip(x, 0, 255).astype(np.uint8)


def libjpeg_version() -> str:
    header = Path("/usr/include/x86_64-linux-gnu/jconfig.h")
    for line in (header.read_text().splitlines() if header.exists() else []):
        if "LIBJPEG_TURBO_VERSION " in line:
            return "libjpeg-turbo " + line.split()[-1]
    return "libjpeg (version unknown)"


def main() -> None:
    import cv2

    from aihab_clip_tpu.native import native_decode_resize_mem

    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    manifest = {"written_by": libjpeg_version() + " (jcarith.c)",
                "files": {}}
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "writer.c"
        src.write_text(WRITER_C)
        exe = Path(tmp) / "writer"
        subprocess.run(["cc", "-O1", "-o", str(exe), str(src), "-ljpeg"],
                       check=True)
        for i, (name, (h, w), colour, (hs, vs), prog, ri, rr, dac,
                orient) in enumerate(FILES):
            ch = {"gray": 1, "cmyk": 4, "ycck": 4}.get(colour, 3)
            raw = Path(tmp) / "pixels.raw"
            raw.write_bytes(photo(h, w, ch, seed=100 + i).tobytes())
            path = OUT / f"{name}.jpg"
            cond = [str(v) for t in (dac or ()) for v in t]
            subprocess.run([str(exe), str(raw), str(path), str(w), str(h),
                            colour, "85", str(hs), str(vs), str(int(prog)),
                            str(ri), str(rr), str(orient), *cond],
                           check=True)
            data = path.read_bytes()
            manifest["files"][path.name] = dict(
                width=w, height=h, colour=colour, sampling=[hs, vs],
                quality=85, sof=10 if prog else 9, restart_interval=ri,
                restart_in_rows=rr, conditioning=dac, orientation=orient,
                bytes=len(data))
            plain = native_decode_resize_mem(data, 64, 0)
            pre = native_decode_resize_mem(data, 64, 128)
            if plain is not None:
                ref[f"{name}/native64"] = plain
            if pre is not None and (plain is None
                                    or not np.array_equal(pre, plain)):
                ref[f"{name}/native64_pre"] = pre
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            if img is not None and h * w < 64 * 64:
                ref[f"{name}/cv2"] = img[:, :, ::-1]
    np.savez_compressed(OUT / "reference.npz", **ref)
    (OUT / "MANIFEST.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"wrote {len(FILES)} files to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
