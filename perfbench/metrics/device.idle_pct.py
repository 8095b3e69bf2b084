"""device.idle_pct: the share of a profiled slice of steps (right after
the timed window, same loop) in which no operation ran on the card: one
minus the union of the device operations' intervals over the slice's wall
time, which runs from a synchronised card to a synchronised card."""


def read(run):
    sl = run.slice
    if sl is None or sl.window_s <= 0 or not sl.device_ops:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
