"""The pipeline layer's self time, as a share of the traced window: host
seconds inside ``PipelineDecoder.decode_posts`` outside its decoders'
``decode`` calls (packing the posts, splitting by orientation, the CRC and
index classification), in %."""


def read(rec):
    spans, window = rec.get("spans"), rec.get("window")
    if not spans or not window:
        return None
    total = {}
    for name, t0, t1 in spans:
        total[name] = total.get(name, 0.0) + (t1 - t0)
    if "pipeline.decode_posts" not in total:
        return None
    own = total["pipeline.decode_posts"] - total.get("decoder.decode", 0.0)
    return 100.0 * own / window["seconds"]
