"""EXIF GPS geotag reading/writing for photogrammetry.

Parity targets (reference neilpy/neilpy.py): exif_dict_to_dd
2162-2189, dd_to_exif_tuple 2194-2202, read_geotags_into_df 2205-2227,
ppk_images 2321-2391.

piexif is absent from the runtime image, so the GPS IFD is read
through PIL's native EXIF support and presented in the same
piexif-style ``{'GPS': {tag: value}, 'Exif': {tag: value}}`` dict the
reference functions consume — ``exif_dict_to_dd`` therefore accepts
either source.
"""

from __future__ import annotations

import glob
import os
import datetime

import numpy as np
import pandas as pd

__all__ = ["exif_dict_to_dd", "dd_to_exif_tuple", "load_exif_dict",
           "read_geotags_into_df", "ppk_images"]


def _as_rational_pair(v):
    """Normalise PIL / piexif rational representations to (num, den)."""
    if isinstance(v, tuple) and len(v) == 2 and all(
            isinstance(i, (int, np.integer)) for i in v):
        return int(v[0]), int(v[1])
    # PIL IFDRational
    num = getattr(v, "numerator", None)
    den = getattr(v, "denominator", None)
    if num is not None:
        return int(num), int(den if den else 1)
    return int(v), 1


def load_exif_dict(im):
    """Build a piexif-style dict from a PIL image (GPS + Exif IFDs)."""
    from PIL import ExifTags
    exif = im.getexif()
    gps_raw = exif.get_ifd(ExifTags.IFD.GPSInfo)
    exif_raw = exif.get_ifd(ExifTags.IFD.Exif)

    gps = {}
    for tag, value in dict(gps_raw).items():
        if isinstance(value, (tuple, list)) and value and not isinstance(
                value[0], (bytes, str)):
            gps[tag] = tuple(_as_rational_pair(v) for v in value)
        elif isinstance(value, str):
            gps[tag] = value.encode()
        elif hasattr(value, "numerator"):
            gps[tag] = _as_rational_pair(value)
        else:
            gps[tag] = value
    ex = {}
    for tag, value in dict(exif_raw).items():
        ex[tag] = value.encode() if isinstance(value, str) else value
    return {"GPS": gps, "Exif": ex}


def exif_dict_to_dd(exif_dict):
    """piexif-style GPS dict -> (lon, lat, alt, gpstime, gpsdate,
    clockdatetime) in decimal degrees (parity: neilpy.py:2162-2189)."""
    gps = exif_dict["GPS"]

    def dms_to_dd(dms):
        d = dms[0][0] / dms[0][1] if dms[0][1] else dms[0][0]
        m = dms[1][0] / dms[1][1] if dms[1][1] else dms[1][0]
        s = dms[2][0] / dms[2][1] if dms[2][1] else dms[2][0]
        return d + m / 60 + s / 3600

    lat = dms_to_dd(gps[2])
    if gps.get(1) in (b"S", "S"):
        lat = -lat
    lon = dms_to_dd(gps[4])
    if gps.get(3) in (b"W", "W"):
        lon = -lon
    import logging
    _log = logging.getLogger(__name__)
    # altitude / time / date tags are genuinely optional in EXIF GPS
    # IFDs; a missing or malformed one degrades that field to NaN, and
    # the debug log names which (so corrupt metadata is attributable)
    alt = gpstime = gpsdate = clockdatetime = np.nan
    try:
        alt = gps[6][0] / gps[6][1]
        if gps.get(5) == 1:
            alt = -alt
    except (KeyError, TypeError, ZeroDivisionError) as e:
        _log.debug("GPSAltitude (tag 6) unusable: %r", e)
    try:
        h = gps[7][0][0] // max(gps[7][0][1], 1)
        m = gps[7][1][0] // max(gps[7][1][1], 1)
        s = gps[7][2][0] / max(gps[7][2][1], 1)
        gpstime = f"{h}:{int(m):02d}:{s:06.3f}"[:-4] \
            if s != int(s) else f"{h}:{int(m):02d}:{int(s):02d}"
    except (KeyError, TypeError) as e:
        _log.debug("GPSTimeStamp (tag 7) unusable: %r", e)
    try:
        gpsdate = gps[29].decode("utf-8") if isinstance(gps[29], bytes) \
            else gps[29]
    except KeyError:
        _log.debug("GPSDateStamp (tag 29) absent")
    try:
        v = exif_dict["Exif"][36867]
        clockdatetime = v.decode("utf-8") if isinstance(v, bytes) else v
    except KeyError:
        _log.debug("DateTimeOriginal (tag 36867) absent")
    return lon, lat, alt, gpstime, gpsdate, clockdatetime


def dd_to_exif_tuple(dd):
    """Decimal degrees -> EXIF rational DMS tuple (parity:
    neilpy.py:2194-2202).  Sign must be handled via the N/S, E/W tags."""
    dd = abs(dd)
    d = int(np.floor(dd))
    m = int(np.floor(60 * (dd - d)))
    s = (dd - d - m / 60) * 3600
    return ((d, 1), (m, 1), (int(np.floor(10000 * s)), 10000))


def read_geotags_into_df(fns, return_datetimes=True):
    """Batch EXIF geotags -> DataFrame (parity: neilpy.py:2205-2227,
    modernised off the removed ``df.append`` API)."""
    from PIL import Image
    rows = []
    for fn in fns:
        with Image.open(fn) as im:
            exif_dict = load_exif_dict(im)
            lon, lat, alt, gpstime, gpsdate, clockdatetime = \
                exif_dict_to_dd(exif_dict)
            if isinstance(gpsdate, str):
                gpsdatetime = gpsdate.replace(":", "-") + " " + str(gpstime)
            else:
                gpsdatetime = np.nan
            rows.append([fn, lat, lon, alt, gpsdatetime, clockdatetime])
    df = pd.DataFrame(rows, columns=["fn", "lat", "lon", "alt",
                                     "datetime_gps", "datetime_clock"])
    if return_datetimes:
        df["datetime_gps"] = pd.to_datetime(df["datetime_gps"])
    return df


def ppk_images(rtk_log, image_paths, out_file=None, time_delta=0,
               gps_height=0, camera_pitch=None, gopro=False,
               gpstimeoffset=18, h_acc=0, v_acc=0):
    """PPK geotagging pipeline: interpolate an RTK track to photo
    capture times, estimate accuracies, derive omega/phi/kappa
    (parity: neilpy.py:2321-2391)."""
    from .gnss import (read_llh, fix_gopro_bad_time_resolution2,
                       track2azimuth, ypr2opk)

    # sorted: glob order is filesystem-dependent, and the yaw estimate
    # (track2azimuth over successive photo positions) depends on photo
    # order — the reference inherits glob's arbitrary order
    fns = sorted(glob.glob(image_paths))
    rtk_df = read_llh(rtk_log, return_datetimes=True)
    photos_df = read_geotags_into_df(fns, return_datetimes=True)
    photos_df["fn"] = photos_df["fn"].apply(os.path.basename)

    if gopro:
        photos_df["datetime_gps_fixed"] = fix_gopro_bad_time_resolution2(
            photos_df["datetime_gps"], gpstimeoffset)
    else:
        photos_df["datetime_gps_fixed"] = photos_df["datetime_gps"]
    photos_df["datetime_gps_fixed"] = (
        photos_df["datetime_gps_fixed"]
        + datetime.timedelta(seconds=time_delta))

    tq = photos_df["datetime_gps_fixed"].astype("int64")
    tr = rtk_df["datetime_gps"].astype("int64")
    for col in ("lat", "lon", "alt"):
        photos_df["new_" + col] = np.interp(tq, tr, rtk_df[col])

    if h_acc == 0:
        sde_sdn = np.max(rtk_df.loc[:, ["sde", "sdn"]], axis=1)
        photos_df["h_acc"] = np.round(10 * np.interp(tq, tr, sde_sdn), 3)
    else:
        photos_df["h_acc"] = h_acc
    if v_acc == 0:
        photos_df["v_acc"] = np.round(
            10 * np.interp(tq, tr, rtk_df["sdu"]), 3)
    else:
        photos_df["v_acc"] = v_acc

    photos_df["new_alt"] = photos_df["new_alt"] - gps_height

    if camera_pitch is not None:
        photos_df["yaw"] = track2azimuth(photos_df.new_lat.values,
                                         photos_df.new_lon.values)
        photos_df["pitch"] = camera_pitch
        o, p, k = ypr2opk(photos_df.yaw, photos_df.pitch)
        photos_df["omega"] = np.round(o, 2)
        photos_df["phi"] = np.round(p, 2)
        photos_df["kappa"] = np.round(k, 2)
    else:
        photos_df["omega"] = 0
        photos_df["phi"] = 0
        photos_df["kappa"] = 0

    out = photos_df.loc[:, ["fn", "new_lat", "new_lon", "new_alt",
                            "omega", "phi", "kappa", "h_acc", "v_acc"]]
    out = out.rename(columns={"new_lat": "lat", "new_lon": "lon",
                              "new_alt": "alt"})
    if out_file is not None:
        out.to_csv(out_file, index=False)
    return out
