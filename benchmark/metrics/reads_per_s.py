"""Reads decoded a second: every read of every call of the window over the
time from the window's start to the end of its last call (host clock)."""


def read(rec):
    w = rec.get("window")
    return w["reads"] / w["seconds"] if w and w["seconds"] > 0 else None
