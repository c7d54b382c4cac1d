"""95th percentile of request latency over every request of the window:
from when it was sent to its answer
(host clock).  Requests that never answered fail ``correct`` instead."""
import numpy as np


def read(obs):
    lat = [(req.t_done - t) * 1e3 for req, t, _ in obs.records if req.done]
    return float(np.percentile(np.asarray(lat, float), 95)) if lat else None
