"""95th percentile, over every request answered in the window, of the
time from handing its batch to `BatchServer.run` to `run` returning its
first token on the host."""
import numpy as np


def read(ctx):
    lat = [b.t_back - b.t_hand for b in ctx.batches for _ in range(b.served)]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
