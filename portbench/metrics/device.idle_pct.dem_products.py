"""device.idle_pct.dem_products: ``device.idle_pct``'s arithmetic in the
DEM-products cell: the share of the traced window in which no kernel,
copy or fill ran on the device."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
