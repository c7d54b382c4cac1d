"""Share of the traced window in which no operation ran on the device: one
less the union of the device's activity intervals over the window."""


def read(obs):
    if obs.trace is None or obs.trace["device_events"] == 0:
        return None
    return 1.0 - obs.trace["busy_s"] / obs.trace["window_s"]
