"""Lockstep evaluation throughput: observations answered by every
``predict_batch`` call of the window over the window's seconds."""

NAME, UNIT, TRACE = "serve_obs_per_s", "obs/s", 0


def read(record):
    if record.get("kind") != "serve" or not record.get("window_s"):
        return None
    return record["observations"] / record["window_s"]
