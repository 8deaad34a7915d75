"""engine.commit_s: host seconds of the set-up's `db.commit()` (the API and
engine layer: `api.py`, `engine/engine.py`), which writes the bulk-loaded
rows into one flat segment. Moves `setup_s`."""


def read(rec):
    return rec.commit_s
