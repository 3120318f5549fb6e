"""Kernel launches a block step in the traceback: the CUDA runtime's launch
calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``) whose host start lies
inside a program ``decoder.traceback`` range, over the block steps the
program's ``decoder.blocks`` counter counted, in one ``torch.profiler``
pass over the pool's first batch of each orientation
(``program_trace.profile_pass``)."""
from benchmark import program_trace


def collect(ctx):
    p = program_trace.profile_pass(ctx)
    return {} if p is None else {"program_profile_pass": p}


def read(rec):
    return program_trace.per_block(rec, "program_profile_pass", "launches")
