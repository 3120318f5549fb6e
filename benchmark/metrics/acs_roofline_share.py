"""The ACS step's share of its roofline, in %: the least time the card could
take for the block steps of one call, the bytes their data need
(``frozen/roofline.py`` ``acs_needed_bytes``, counted on tables the
benchmark builds itself) over the card's 3.35 TB/s, against the device
time of the ACS step as the decoder calls it by default.

The step is the one ``LVADecoder.decode_device`` picks when given none
(``ops/lva.py``: ``acs_block`` under max combining), wrapped here and handed
to ``PipelineDecoder.decode_posts``; each of its calls is timed by CUDA
events on the stream, whatever kernel implements it. The call decodes the
pool's first batch of forward reads twice: once timed, once with the bytes
counted after every ``STRIDE``-th step (the step's output is the
stale buffer after it); the share is over those steps. Where the program
takes no step from its caller, or combines paths by logsumexp, it reads
nothing.
"""
import inspect

import torch

from benchmark.frozen.config import DecodeConfig
from benchmark.frozen.lva_consts import DecodeSpec, LVAConsts
from benchmark.frozen.roofline import HBM_BYTES_PER_S, acs_needed_bytes
from benchmark.traffic import code_config

# count the bytes of every STRIDE-th block step
STRIDE = 4


class Timed:
    """The step, with CUDA events on the stream before and after each call."""

    def __init__(self, step):
        self.step, self.events = step, []

    def __call__(self, tabs, prev, stale, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(tabs, prev, stale, *args)
        end.record()
        self.events.append((start, end))
        return out

    def seconds(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) / 1e3 for s, e in self.events]


class Counted:
    """The step, then the bytes it needed at every ``stride``-th call."""

    def __init__(self, step, tabs, stride):
        self.step, self.tabs, self.stride = step, tabs, stride
        self.calls, self.bytes = 0, {}

    def __call__(self, tabs, prev, stale, *args):
        out = self.step(tabs, prev, stale, *args)
        if self.calls % self.stride == 0:
            *rest, sel = args
            self.bytes[self.calls] = acs_needed_bytes(
                self.tabs, prev[0], stale[0], sel, *rest)
        self.calls += 1
        return out


def collect(ctx):
    step = ctx.program.default_acs()
    takes_step = "acs" in inspect.signature(
        ctx.program.pd.decode_posts).parameters
    if (ctx.device.type != "cuda" or step is None or not takes_step
            or ctx.config["path_combine"] != "max"):
        return {}
    reads = ctx.batch_of(False)
    timed = Timed(step)
    ctx.call(reads, acs=timed)
    seconds = timed.seconds()
    spec, tables = DecodeSpec.build(DecodeConfig(
        code=code_config(ctx.config), list_size=ctx.config["list_size"],
        max_deviation=ctx.config["max_deviation"]))
    counted = Counted(step, LVAConsts.build(spec, tables).to(ctx.device),
                      STRIDE)
    ctx.call(reads, acs=counted)
    if counted.calls != len(seconds):
        return {}
    return {"acs_device_s": sum(seconds[t] for t in counted.bytes),
            "acs_needed_bytes": sum(counted.bytes.values()),
            "acs_steps_counted": len(counted.bytes)}


def read(rec):
    if not rec.get("acs_device_s"):
        return None
    bound_s = rec["acs_needed_bytes"] / HBM_BYTES_PER_S
    return 100.0 * bound_s / rec["acs_device_s"]
