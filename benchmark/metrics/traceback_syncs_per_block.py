"""Host synchronisations a block step in the traceback: the CUDA runtime's
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and synchronous ``cudaMemcpy`` calls whose host
start lies inside a program ``decoder.traceback`` range, over the block
steps the program's ``decoder.blocks`` counter counted, in the profile of
``traceback_launches_per_block`` (``program_trace.profile_pass``)."""
from benchmark import program_trace


def collect(ctx):
    p = program_trace.profile_pass(ctx)
    return {} if p is None else {"program_profile_pass": p}


def read(rec):
    return program_trace.per_block(rec, "program_profile_pass", "syncs")
