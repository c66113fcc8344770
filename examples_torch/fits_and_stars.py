"""FITS image handling + star precession
(reference: Fits.zig / EquatorialCoordinateSystem.zig demos; the PyTorch
port of examples/fits_and_stars.py). Host code only: ``device`` is not
used.

Run: ``python examples_torch/fits_and_stars.py`` (writes its FITS and
PGM files into a temporary directory).
"""

import os
import tempfile

import numpy as np

from astroz_tpu_torch.equatorial import Declination, RightAscension, precess
from astroz_tpu_torch.fits import Fits, image_to_pgm

BLOCK = 2880


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = f"{'T' if value else 'F':>20}"
    elif isinstance(value, (int, float)):
        v = f"{value:>20}"
    else:
        v = f"'{value:<8}'"
    return f"{key:<8}= {v} / {comment}".ljust(80)[:80].encode("ascii")


def make_image_fits(path, arr):
    """A one-HDU FITS file of a 16-bit image (BSCALE 2, BZERO 100)."""
    arr = np.asarray(arr, ">i2")
    cards = [_card("SIMPLE", True), _card("BITPIX", 16), _card("NAXIS", 2),
             _card("NAXIS1", arr.shape[1]), _card("NAXIS2", arr.shape[0]),
             _card("BSCALE", 2.0), _card("BZERO", 100.0),
             _card("OBJECT", "TESTOBJ", "synthetic"), b"END".ljust(80)]
    header = b"".join(cards)
    data = arr.tobytes()
    with open(path, "wb") as f:
        f.write(header + b" " * (-len(header) % BLOCK))
        f.write(data + b"\0" * (-len(data) % BLOCK))


def main(device="cuda", small=False):
    with tempfile.TemporaryDirectory() as tmp:
        img = (np.add.outer(np.arange(32), np.arange(32)) % 17).astype(
            np.int16)
        fits_path = os.path.join(tmp, "demo.fits")
        make_image_fits(fits_path, img)
        f = Fits.open(fits_path)
        hdu = f[0]
        print(f"{len(f)} HDU(s); primary {hdu.shape}, "
              f"OBJECT={hdu.header['OBJECT']}")
        pgm_path = os.path.join(tmp, "demo.pgm")
        image_to_pgm(hdu.image(), pgm_path, stretch="sqrt")
        print(f"wrote {pgm_path}")

    # precess Betelgeuse from J2000 to J2050
    ra, dec = RightAscension(5, 55, 10.3), Declination(7, 24, 25.4)
    ra2, dec2 = precess(ra, dec, 2451545.0 + 50 * 365.25)
    print(f"Betelgeuse J2050: RA {ra2.hours}h{ra2.minutes}m"
          f"{ra2.seconds:.1f}s Dec {dec2.degrees}d{dec2.arcminutes}m"
          f"{dec2.arcseconds:.0f}s")


if __name__ == "__main__":
    main()
