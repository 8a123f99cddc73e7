"""tiling.store_ms_per_tile: the tile stream's writer, milliseconds of
one tile's ``tiling.store`` span (unpack, decode, crop and copy into the
outputs, the checkpoint mark), the mean over the traced window's
tiles."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    stores = ps.named(spans or [], "tiling.store")
    if not stores:
        return None
    return 1e3 * ps.seconds(stores) / len(stores)
