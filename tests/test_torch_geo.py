"""The PyTorch port's host geodesy and photogrammetry modules
(``neilpy_tpu_torch/geo``, ``neilpy_tpu_torch/photo``) held equal to the
JAX package's, bit for bit, on the control points of
``tests/test_stats_viz_aux.py`` (``TestGeo``, ``TestGnssPhoto``) and
``tests/test_core.py:169``.  Where the JAX function raises (a CRS
family it refuses, a PROJ grid that is not installed) the port raises
the same exception type with the same message."""

import numpy as np
import pandas as pd
import pytest
from PIL import ExifTags, Image

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt

# (code, lon, lat) of every control point of tests/test_stats_viz_aux.py
CONTROL = [
    (32617, -81.0, 40.0), (32617, -80.4, 37.2), (32759, 173.0, -41.0),
    (26918, -74.0, 40.7), (3857, 12.5, 41.9),
    (26941, -122.5, 40.5), (2225, -122.5, 40.5), (32118, -73.8, 40.75),
    (2263, -73.8, 40.75), (32140, -98.5, 29.4), (32119, -79.5, 35.2),
    (26958, -81.2, 26.0), (32111, -74.5, 40.0), (26929, -85.8, 32.5),
    (5070, -105.0, 40.0), (6350, -75.0, 45.0), (3413, 10.0, 80.0),
    (3031, 100.0, -80.0), (3078, -85.0, 44.0), (3375, 102.25, 3.5),
    (8065, -111.0, 32.2), (20050, -75.0, 40.0), (3035, 10.0, 52.0),
    (3571, -150.0, 70.0), (3573, -100.0, 75.0), (3395, 12.34, 45.6),
    (3832, 150.0, 20.0), (3994, 170.0, -44.0), (5641, -45.0, -10.0),
    (3377, 103.5, 2.0), (2953, -66.0, 46.5), (2954, -63.1, 46.4),
    (2048, 19.5, -33.5), (2051, 25.5, -29.0), (27700, -0.12, 51.5),
    (28992, 5.12, 52.09), (2056, 7.44, 46.95), (31370, 4.35, 50.85),
    (21781, 7.44, 46.95), (23030, -3.7, 40.4), (23032, 9.2, 45.5),
    (29193, -47.9, -15.8), (2100, 23.7, 38.0), (2039, 35.2, 31.78),
    (3006, 18.06, 59.33), (2193, 174.78, -41.29), (31466, 6.96, 50.94),
    (31467, 11.57, 48.14), (27260, 178.0, -38.5), (27291, 174.78, -38.0),
    (27200, 174.78, -41.29), (27200, 170.5, -45.9), (6247, -74.1, 4.68),
    (6244, -70.5, 7.1), (5514, 14.42, 50.09), (5514, 17.1, 48.15),
    (5513, 14.42, 50.09), (2065, 14.42, 50.09), (27561, 2.35, 48.85),
    (27572, 2.35, 48.85), (4087, 100.0, 30.0), (4275, 2.35, 48.85),
    (4277, -0.12, 51.5), (26729, -85.8, 32.5), (99999, 0.0, 0.0),
]


def outcome(fn, *args, **kw):
    """What a call gives: ("ok", result) or ("raise", type, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the comparison is of the failure itself
        return ("raise", type(e), str(e))


def same(a, b):
    """Equal outcomes: the same exception, or equal results bit for bit
    (arrays, scalars, frames and tuples of them, NaN where NaN)."""
    if a[0] != "ok" or b[0] != "ok":
        assert a == b
        return
    a, b = a[1], b[1]
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_exact=True)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for u, v in zip(a, b):
            same(("ok", u), ("ok", v))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("code,lon,lat", CONTROL)
def test_coord_transform_round_trip_equals_the_jax_package(code, lon, lat):
    lons = np.array([lon, lon + 0.01, lon - 0.02])
    lats = np.array([lat, lat - 0.01, lat + 0.005])
    for x, y in ((lon, lat), (lons, lats)):
        fwd = outcome(ntt.coord_transform, x, y, 4326, code)
        same(fwd, outcome(nt.coord_transform, x, y, 4326, code))
        if fwd[0] == "ok":
            back = outcome(ntt.coord_transform, *fwd[1], code, 4326)
            same(back, outcome(nt.coord_transform, *fwd[1], code, 4326))
    same(outcome(ntt.coord_transform, -74.0, 40.7, 4269, 26918),
         outcome(nt.coord_transform, -74.0, 40.7, 4269, 26918))


def test_utm_geodesics_and_geoid():
    """tests/test_core.py:169's UTM round trip, the geodesic helpers
    and the EGM96 geoid (its antimeridian columns too)."""
    from neilpy_tpu.geo import proj as jproj
    from neilpy_tpu_torch.geo import proj as tproj
    for zone, north, lon, lat in ((19, True, -71.3, 44.27),
                                  (33, False, 14.9, -33.1)):
        xy = outcome(tproj.utm_forward, lon, lat, zone, north)
        same(xy, outcome(jproj.utm_forward, lon, lat, zone, north))
        same(outcome(tproj.utm_inverse, *xy[1], zone, north),
             outcome(jproj.utm_inverse, *xy[1], zone, north))
    lon2 = np.array([1.0, 179.5, -60.0])
    lat2 = np.array([1.0, -0.5, 45.0])
    same(outcome(ntt.geodesic_inverse, 0.0, 0.0, lon2, lat2),
         outcome(nt.geodesic_inverse, 0.0, 0.0, lon2, lat2))
    same(outcome(ntt.great_circle_distance, 0.0, 0.0, 0.0, 90.0),
         outcome(nt.great_circle_distance, 0.0, 0.0, 0.0, 90.0))
    pts = (np.array([5.0, -74.0, 179.9, -179.9]),
           np.array([52.0, 40.7, 0.0, 0.0]))
    for name in ("geoid_height",):
        same(outcome(getattr(ntt, name), *pts),
             outcome(getattr(nt, name), *pts))
    for name in ("ellipsoidal_to_orthometric", "orthometric_to_ellipsoidal"):
        same(outcome(getattr(ntt, name), 100.0, *pts),
             outcome(getattr(nt, name), 100.0, *pts))
    same(outcome(ntt.geoid_height, 5.0, 52.0, path="/nonexistent.gtx"),
         outcome(nt.geoid_height, 5.0, 52.0, path="/nonexistent.gtx"))


def test_ntv2_grid_reader():
    from neilpy_tpu.geo import ntv2 as jn
    from neilpy_tpu_torch.geo import ntv2 as tn
    for name in ("BETA2007.gsb", "ntf_r93.gsb", "nzgd2kgrid0005.gsb",
                 "CHENyx06_ETRS.gsb", "no_such_grid.gsb"):
        same(outcome(tn._find_grid_file, name),
             outcome(jn._find_grid_file, name))
        path = outcome(jn._find_grid_file, name)
        if path[0] == "ok" and path[1]:
            lon, lat = np.array([9.0, 2.35, 174.7]), np.array([48.2, 48.85,
                                                               -41.3])
            for inv in (False, True):
                same(outcome(tn.apply_grid, path[1], lon, lat, inv),
                     outcome(jn.apply_grid, path[1], lon, lat, inv))


LLH = ("2023/05/01 12:00:{s:02d}.000  {lat} {lon} {h} {q} 10 "
       "0.01 0.01 0.02 0 0 0 0.5 3.1\n")


def _llh(path, n=20):
    path.write_text("".join(
        LLH.format(s=s, lat=37.23 + 1e-4 * s, lon=-80.42 - 1e-4 * s,
                   h=600.0 + s, q=1 + s % 2) for s in range(n)))
    return str(path)


def test_gnss_readers_and_track_helpers(tmp_path):
    fn = _llh(tmp_path / "log.llh")
    df = outcome(ntt.read_llh, fn)
    same(df, outcome(nt.read_llh, fn))
    same(outcome(ntt.read_llh, fn, return_datetimes=False),
         outcome(nt.read_llh, fn, return_datetimes=False))
    pos = tmp_path / "log.pos"
    pos.write_text("% comment\n" + (tmp_path / "log.llh").read_text())
    same(outcome(ntt.read_pos, str(pos)), outcome(nt.read_pos, str(pos)))
    t = df[1]["datetime_utc"]
    for how in ("time", "date", "datetime"):
        same(outcome(ntt.stringify_time, t, how),
             outcome(nt.stringify_time, t, how))
    times = pd.Series(pd.to_datetime(["2023-01-01 00:00:00"] * 2
                                     + ["2023-01-01 00:00:01"] * 3))
    same(outcome(ntt.fix_gopro_bad_time_resolution2, times, 18),
         outcome(nt.fix_gopro_bad_time_resolution2, times, 18))
    same(outcome(ntt.fix_gopro_bad_time_resolution, times),
         outcome(nt.fix_gopro_bad_time_resolution, times))
    lat = np.array([0.0, 1.0, 2.0, 2.5])
    lon = np.array([0.0, 0.0, 0.3, -0.4])
    same(outcome(ntt.track2azimuth, lat, lon),
         outcome(nt.track2azimuth, lat, lon))
    for yaw, pitch, roll in ((0.0, -90.0, 0), (90.0, -45.0, 0),
                             (np.array([10.0, 200.0]),
                              np.array([-80.0, -30.0]), 5.0)):
        same(outcome(ntt.ypr2opk, yaw, pitch, roll),
             outcome(nt.ypr2opk, yaw, pitch, roll))
    survey = pd.DataFrame({"Name": ["p1", "p2"],
                           "Collection Start": ["2023-05-01 11:59:43",
                                                "2023-05-01 11:59:51"],
                           "Collection End": ["2023-05-01 11:59:50",
                                              "2023-05-01 11:59:58"]})
    got = outcome(ntt.posprocessor, survey, df[1])
    assert got[1]["lat"].notna().all()  # the windows hold fixes (UTC)
    same(got, outcome(nt.posprocessor, survey, df[1]))


def _geotagged(tmp_path, n=4):
    im = Image.new("RGB", (8, 8))
    for i in range(n):
        exif = Image.Exif()
        exif[ExifTags.IFD.GPSInfo] = {
            1: "N", 2: (37.0, 13.0, 48.0 + i), 3: "W",
            4: (80.0, 25.0, 12.0 + 2 * i), 5: 0, 6: 600.0 + i,
            7: (12.0, 0.0, 2.0 + i), 29: "2023:05:01"}
        exif[ExifTags.IFD.Exif] = {36867: f"2023:05:01 12:00:{i + 1:02d}"}
        im.save(tmp_path / f"img{i}.jpg", exif=exif)
    return sorted(str(p) for p in tmp_path.glob("img*.jpg"))


def test_exif_and_ppk(tmp_path):
    for dd in (-80.123456, 37.5, 0.0001):
        same(outcome(ntt.dd_to_exif_tuple, dd),
             outcome(nt.dd_to_exif_tuple, dd))
    d = {"GPS": {1: b"N", 2: ((37, 1), (13, 1), (480000, 10000)),
                 3: b"W", 4: ((80, 1), (25, 1), (120000, 10000)),
                 5: 0, 6: (6000, 10)},
         "Exif": {36867: b"2023:05:01 12:00:00"}}
    same(outcome(ntt.exif_dict_to_dd, d), outcome(nt.exif_dict_to_dd, d))
    fns = _geotagged(tmp_path)
    same(outcome(ntt.read_geotags_into_df, fns),
         outcome(nt.read_geotags_into_df, fns))
    log = _llh(tmp_path / "rtk.llh")
    kw = dict(time_delta=0, gps_height=0.1, camera_pitch=-90.0)
    same(outcome(ntt.ppk_images, log, str(tmp_path / "img*.jpg"), **kw),
         outcome(nt.ppk_images, log, str(tmp_path / "img*.jpg"), **kw))


def test_the_jax_names_missing_from_the_port_are_the_unported_ones():
    """Every top-level name of the JAX package is in the port but the
    one module not carried over (``aot``, replaced by the build cache)."""
    ours = {n for n in dir(ntt) if not n.startswith("_")}
    theirs = {n for n in dir(nt) if not n.startswith("_")}
    assert theirs - ours == {"aot"}
    assert ntt.geo.proj.coord_transform is ntt.coord_transform
    assert ntt.photo.gnss.read_llh is ntt.read_llh
