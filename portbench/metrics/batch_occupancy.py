"""batch_occupancy (%): the window's decode steps over its waves times the
session's slots (``ServeSession.stats``; layer: session and scheduling)."""


def read(record):
    serve = record.get("serve")
    if serve is None or not serve["stats"]["waves"]:
        return None
    st = serve["stats"]
    return 100.0 * st["decode_steps"] / (st["waves"] * serve["max_batch"])
