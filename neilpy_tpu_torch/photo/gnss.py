"""GNSS log processing: Emlid Reach / RTKLIB LLH+POS readers, survey
post-processing, GoPro timestamp repair.

Parity targets (reference neilpy/neilpy.py): read_llh/read_pos
2132-2157, stringify_time 2231-2235, fix_gopro_bad_time_resolution{,2}
2239-2316, posprocessor 2558-2583, track2azimuth 2425-2440, ypr2opk
2407-2420.

geopandas is optional in this build: readers return a plain DataFrame
(with a geometry column attached when geopandas is importable).
"""

from __future__ import annotations

import datetime

import numpy as np
import pandas as pd

from ..geo.proj import geodesic_inverse

__all__ = ["read_llh", "read_pos", "stringify_time",
           "fix_gopro_bad_time_resolution",
           "fix_gopro_bad_time_resolution2", "posprocessor",
           "track2azimuth", "ypr2opk"]


def read_llh(fn, return_datetimes=True, skiprows=0, comment="%"):
    """Emlid Reach / RTKLIB LLH log -> DataFrame (parity:
    neilpy.py:2132-2150).  Q=1 fix, 2 float, 3 sbas, 4 dgps, 5 single,
    6 ppp.  GPS->UTC applies the -18 s leap-second offset."""
    df = pd.read_csv(fn, header=None, sep=r"\s+", skiprows=skiprows,
                     comment=comment)
    df = df.rename({0: "date_gps", 1: "time_gps", 2: "lat", 3: "lon",
                    4: "alt", 5: "Q", 6: "num_sat", 7: "sdn", 8: "sde",
                    9: "sdu", 10: "sdne", 11: "sdeu", 12: "sdun",
                    13: "age", 14: "ratio"}, axis=1)
    if return_datetimes:
        tm = df.iloc[:, 0].astype(str) + " " + df.iloc[:, 1].astype(str)
        df["datetime_gps"] = pd.to_datetime(tm)
        df["datetime_utc"] = (df["datetime_gps"]
                              - datetime.timedelta(seconds=18))
    try:
        import geopandas
        df = geopandas.GeoDataFrame(
            df, geometry=geopandas.points_from_xy(df.lon, df.lat))
        df = df.set_crs(epsg=4326)
    except ImportError:
        import logging
        logging.getLogger(__name__).debug(
            "geopandas not installed: read_llh returns a plain "
            "DataFrame (no geometry column)")
    return df


def read_pos(fn, return_datetimes=True):
    """RTKLIB .pos log reader (parity: neilpy.py:2155-2157)."""
    return read_llh(fn, return_datetimes, comment="%")


def stringify_time(series, how="time"):
    """Datetime series -> string (parity: neilpy.py:2231-2235)."""
    if how == "datetime":
        return series.dt.strftime("%Y:%m:%d %H:%M:%S.%f").str[:-5]
    return series.dt.strftime("%H:%M:%S.%f").str[:-5]


def _within_second_increments(series):
    """Occurrence count per timestamp plus running index within each
    run of equal consecutive timestamps (vectorised replacement for
    the reference's python loop, neilpy.py:2257-2264)."""
    df = pd.DataFrame({"key": series.to_numpy()})
    counts = df.groupby("key")["key"].transform("size")
    new_run = df["key"].ne(df["key"].shift())
    run_id = new_run.cumsum()
    increment = df.groupby(run_id).cumcount() + 1
    return counts, increment


def fix_gopro_bad_time_resolution(series):
    """De-alias 1 s-floored GoPro GPS timestamps (parity:
    neilpy.py:2239-2275)."""
    counts, increment = _within_second_increments(series)
    add_to = np.zeros(len(series))
    add_to[(counts >= 2) & (increment == 2)] = .5
    add_to[(counts == 1) & (increment == 1)] = .5
    add_to[(counts == 3) & (increment == 3)] = 1.0
    return series.reset_index(drop=True) + pd.to_timedelta(add_to,
                                                           unit="seconds")


def fix_gopro_bad_time_resolution2(series, gpstimeoffset):
    """Uniform within-second spreading variant (parity:
    neilpy.py:2278-2316): add (i/k) - 1/(2k) seconds for the i-th of k
    photos sharing a floored timestamp, plus the GPS-UTC offset."""
    counts, increment = _within_second_increments(series)
    add_to = (increment / counts) - (1 / (2 * counts))
    return series.reset_index(drop=True) + pd.to_timedelta(
        gpstimeoffset + add_to.to_numpy(), unit="seconds")


def posprocessor(survey_df, pos_df, keep_Q=(1, 2, 5),
                 start_field="collection start",
                 end_field="collection end"):
    """Median GNSS position per survey time window (parity:
    neilpy.py:2558-2583)."""
    survey_df = survey_df.copy()
    survey_df.columns = [str.lower(n) for n in survey_df.columns.values]
    start_field = start_field.lower()
    end_field = end_field.lower()
    survey_df[start_field] = pd.to_datetime(survey_df[start_field])
    survey_df[end_field] = pd.to_datetime(survey_df[end_field])

    rows = []
    for _, row in survey_df.iterrows():
        idx = ((pos_df["datetime_utc"] > row[start_field].to_datetime64())
               & (pos_df["datetime_utc"] < row[end_field].to_datetime64())
               & (pos_df["Q"].isin(list(keep_Q))))
        rows.append({"name": row["name"],
                     "lat": np.median(pos_df.loc[idx, "lat"]),
                     "lon": np.median(pos_df.loc[idx, "lon"]),
                     "alt": np.median(pos_df.loc[idx, "alt"])})
    return pd.DataFrame(rows, columns=["name", "lat", "lon", "alt"])


def track2azimuth(lat, lon):
    """Per-fix forward azimuth along a track, WGS84 geodesic (parity:
    neilpy.py:2425-2440, pyproj replaced by the built-in Vincenty
    inverse)."""
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    fwd, _, _ = geodesic_inverse(lon[:-1], lat[:-1], lon[1:], lat[1:])
    fwd = np.append(fwd, fwd[-1])
    return np.mod(fwd + 360, 360)


def ypr2opk(yaw, pitch, roll=0):
    """Yaw/pitch/roll -> omega/phi/kappa (parity: neilpy.py:2407-2420;
    the reference's buggy ``roll is not 0`` check becomes a real
    comparison)."""
    if np.any(np.asarray(roll) != 0):
        print("Roll values other than zero not yet supported.")
    yaw = np.asarray(yaw, dtype=float)
    pitch = np.asarray(pitch, dtype=float)
    kappa = -yaw
    ang = (2.5 * np.pi - np.deg2rad(yaw)) % (2 * np.pi)
    phi = -(90 + pitch) * np.cos(ang)
    omega = (90 + pitch) * np.sin(ang)
    return omega, phi, kappa
