"""The traceback's host microseconds a block step: seconds inside the
program's own ``decoder.traceback`` spans (``ops/lva.py``; the device
synchronised at both ends in the program's sync mode) over the block steps
its ``decoder.blocks`` counter counted, in a pass without the profiler that
decodes the pool's first batch of each orientation
(``program_trace.span_pass``)."""
from benchmark import program_trace


def collect(ctx):
    p = program_trace.span_pass(ctx)
    return {} if p is None else {"program_span_pass": p}


def read(rec):
    return program_trace.per_block(rec, "program_span_pass", "traceback_s",
                                   1e6)
