"""raster_mpix_s: input DEM pixels of every job completed in the window
over the whole window (its start to the end of the last job, the job in
flight at the deadline finished and counted), in millions per second."""


def read(run):
    return run.mpix_s()
