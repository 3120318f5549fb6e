"""Set-up seconds (host clock): from the start of the process to the end of
the warm-up calls, the file's encoding, the pool of reads, the decoders'
tables and the kernels' build and load in it."""


def read(rec):
    return rec.get("setup_s")
