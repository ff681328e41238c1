"""EXIF/GPS ingest for stills (PIL-based; exifread is not available here).

Parity: reference ``importEXIF``/``fcnEXIF2LLAT``/``dms2degrees``/
``hemisphere2sign`` (the reference's utils/images.py:30-89). Output contract:
``exif_to_llat`` returns [lat_deg, lon_deg, alt_m, seconds_since_midnight].

A copy of ``velocity_tpu/camera/exif.py`` (host-only; PIL is imported inside
the call).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _ratio_to_float(v):
    try:
        return float(v)
    except TypeError:
        # PIL IFDRational with zero denominator etc.
        return float(v.numerator) / float(v.denominator)


def read_exif(path: str | Path) -> dict:
    """Read EXIF tags (including GPS IFD) into a flat {name: value} dict."""
    from PIL import Image
    from PIL.ExifTags import TAGS, GPSTAGS

    out: dict = {}
    with Image.open(str(path)) as im:
        exif = im.getexif()
        for tag_id, value in exif.items():
            out[TAGS.get(tag_id, tag_id)] = value
        try:
            exif_ifd = exif.get_ifd(0x8769)  # ExifIFD
            for tag_id, value in exif_ifd.items():
                out[TAGS.get(tag_id, tag_id)] = value
        except KeyError:
            pass
        try:
            gps_ifd = exif.get_ifd(0x8825)  # GPSInfo
            for tag_id, value in gps_ifd.items():
                out["GPS " + GPSTAGS.get(tag_id, str(tag_id))] = value
        except KeyError:
            pass
    return out


def dms_to_degrees(dms) -> float:
    """[degrees, minutes, seconds] -> decimal degrees."""
    d, m, s = (_ratio_to_float(v) for v in dms)
    return d + m / 60.0 + s / 3600.0


def hemisphere_sign(ref: str) -> float:
    """'N'/'E' -> +1, 'S'/'W' -> -1."""
    return 1.0 if ref in ("N", "E") else -1.0


def exif_to_llat(exif: dict) -> np.ndarray:
    """EXIF dict -> [lat_deg, lon_deg, alt_m, seconds_since_midnight]."""
    time_str = str(exif["DateTimeOriginal"]).split(" ")[1]
    hour, minute, second = (float(x) for x in time_str.split(":"))
    # SubsecTimeOriginal is read as milliseconds whatever its digit count
    # ("5" gives 5 ms, not 500), as in the JAX package
    subsec = float(exif.get("SubsecTimeOriginal", 0) or 0)
    seconds = hour * 3600 + minute * 60 + second + subsec / 1000.0

    llat = np.zeros(4)
    llat[0] = dms_to_degrees(exif["GPS GPSLatitude"]) * hemisphere_sign(
        str(exif["GPS GPSLatitudeRef"])
    )
    llat[1] = dms_to_degrees(exif["GPS GPSLongitude"]) * hemisphere_sign(
        str(exif["GPS GPSLongitudeRef"])
    )
    llat[2] = _ratio_to_float(exif["GPS GPSAltitude"])
    llat[3] = seconds
    return llat


def exif_image_size(exif: dict) -> tuple[float, float]:
    """(width, height) from EXIF."""
    return float(exif["ExifImageWidth"]), float(exif["ExifImageHeight"])


def exif_yaw_deg(exif: dict, declination_deg: float = 2.56) -> float | None:
    """True-north camera yaw from GPSImgDirection + magnetic declination.

    Parity: matlab/runExample.m:49-50 (declination hardcoded 2.56 deg for the
    reference's Santiago dataset).
    """
    if "GPS GPSImgDirection" not in exif:
        return None
    return _ratio_to_float(exif["GPS GPSImgDirection"]) + declination_deg
