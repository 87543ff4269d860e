"""Device idle share under the app loop: the percentage of the traced
window (first trial's start to last trial's end) in which no operation ran
on the device. The apps read one flag an iteration on the host, so each
iteration leaves the device idle while the host reads it and launches the
next."""


def read(r):
    if not r.trace.busy_s:
        return None  # nothing ran on the device
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
