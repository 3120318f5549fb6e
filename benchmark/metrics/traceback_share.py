"""The traceback's share of the decoder's wall time in the traced window:
seconds inside ``ops/lva_decode.py`` ``traceback``, synchronised with the
device at both ends, over the seconds inside ``LVADecoder.decode``, in %."""


def read(rec):
    total = {}
    for name, t0, t1 in rec.get("spans") or ():
        total[name] = total.get(name, 0.0) + (t1 - t0)
    if not total.get("decoder.traceback") or not total.get("decoder.decode"):
        return None
    return 100.0 * total["decoder.traceback"] / total["decoder.decode"]
